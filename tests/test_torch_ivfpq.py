"""Port parity: IVF-PQ build and scans (repro_torch.search.ivfpq) against
repro.search.ivfpq on the same numpy inputs. The build is fed JAX's own
k-means starting rows; the scans run on a JAX-built index carried across
by repro_torch.bridge.state_from_arrays."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.search import build_engine as jax_build_engine  # noqa: E402
from repro.search import ivfpq as jivfpq  # noqa: E402
from repro_torch.bridge import state_from_arrays  # noqa: E402
from repro_torch.search import ivfpq as tivfpq  # noqa: E402

N, D, NLIST, M, K = 2400, 16, 16, 4, 64


def _corpus(seed, n, d=D, n_clusters=12):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 4.0
    lab = rng.integers(0, n_clusters, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


def _jax_inits(key, n):
    """The starting rows JAX's build_ivfpq draws: coarse k-means from
    ``key``, subspace m's codebook from fold_in(fold_in(key, 7), m)."""
    coarse = jax.random.choice(key, n, (NLIST,), replace=False)
    pq_key = jax.random.fold_in(key, 7)
    pq = [jax.random.choice(jax.random.fold_in(pq_key, m), n, (min(K, n),),
                            replace=False) for m in range(M)]
    return (torch.from_numpy(np.asarray(coarse)).long(),
            torch.from_numpy(np.stack([np.asarray(p) for p in pq])).long())


@pytest.fixture(scope="module")
def built():
    x = _corpus(0, N)
    key = jax.random.key(5)
    jidx = jivfpq.build_ivfpq(key, jnp.asarray(x), NLIST, M, K)
    coarse, pq = _jax_inits(key, N)
    tidx = tivfpq.build_ivfpq(torch.from_numpy(x), NLIST, M, K, device="cpu",
                              coarse_init=coarse, pq_inits=pq)
    return x, jidx, tidx


def test_build_centroids_match_given_jax_inits(built):
    _, jidx, tidx = built
    # the one-hot matmul and index_add_ sum the cells in different orders
    np.testing.assert_allclose(tidx.centroids.numpy(),
                               np.asarray(jidx.centroids), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(tidx.lists.numpy(), np.asarray(jidx.lists))


def test_build_codes_match_up_to_near_ties(built):
    x, jidx, tidx = built
    jc = np.asarray(jidx.codes).astype(np.int64)
    tc = tidx.codes.numpy().astype(np.int64)
    diff = jc != tc
    assert diff.mean() <= 1e-3
    # every differing code is a near-tie of the two codeword distances
    cent = tidx.centroids.numpy()
    assign = np.argmin(((x[:, None] - cent[None]) ** 2).sum(-1), axis=1)
    res = (x - cent[assign]).reshape(N, M, D // M)
    cb = tidx.codebooks.numpy()
    for r, m in zip(*np.nonzero(diff)):
        da = ((res[r, m] - cb[m, jc[r, m]]) ** 2).sum()
        db = ((res[r, m] - cb[m, tc[r, m]]) ** 2).sum()
        assert abs(da - db) <= 1e-4 * (1.0 + abs(da))
    np.testing.assert_allclose(tidx.codebooks.numpy(),
                               np.asarray(jidx.codebooks), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def bridged():
    """A JAX engine without a Reduce stage, carried across."""
    x = _corpus(1, N)
    eng = jax_build_engine(x, "ivf16x4>pq4x64")
    flat, _ = jax.tree_util.tree_flatten_with_path(eng.state)
    arrays = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    state = state_from_arrays(arrays, "ivf16x4>pq4x64", device="cpu")
    q = _corpus(2, 64)
    return eng.state.index.payload, state.index.payload, q


def test_bridge_carries_every_array(bridged):
    jix, tix, _ = bridged
    for f in tix._fields:
        np.testing.assert_array_equal(getattr(tix, f).numpy(),
                                      np.asarray(getattr(jix, f)))


def _jax_scan(jix, q, n_cand, lut_dtype, scan_cap=0):
    args = (jix.centroids, jix.lists, jix.codes_cell, jix.bias_cell,
            jix.lut_w, jix.cbnorm, jix.codebooks)
    if scan_cap:
        fn = functools.partial(jivfpq.ivfpq_compact_scan, n_cand=n_cand,
                               nprobe=4, scan_cap=scan_cap, backend="jnp",
                               lut_dtype=lut_dtype)
    else:
        fn = functools.partial(jivfpq.ivfpq_adc_scan, n_cand=n_cand,
                               nprobe=4, backend="jnp", lut_dtype=lut_dtype)
    d2, ids = jax.jit(fn)(*args, jnp.asarray(q))       # as the engine runs it
    return np.asarray(d2), np.asarray(ids)


def _torch_scan(tix, q, n_cand, lut_dtype, scan_cap=0, backend="jnp"):
    args = (tix.centroids, tix.lists, tix.codes_cell, tix.bias_cell,
            tix.lut_w, tix.cbnorm, tix.codebooks, torch.from_numpy(q))
    if scan_cap:
        d2, ids = tivfpq.ivfpq_compact_scan(*args, n_cand, 4, scan_cap,
                                            backend=backend,
                                            lut_dtype=lut_dtype)
    else:
        d2, ids = tivfpq.ivfpq_adc_scan(*args, n_cand, 4, backend=backend,
                                        lut_dtype=lut_dtype)
    return d2.numpy(), ids.numpy()


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_padded_scan_matches_jax(bridged, lut_dtype):
    jix, tix, q = bridged
    dj, ij = _jax_scan(jix, q, 40, lut_dtype)
    dt, it = _torch_scan(tix, q, 40, lut_dtype)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-5)


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_compact_scan_matches_jax_and_padded(bridged, lut_dtype):
    jix, tix, q = bridged
    lens = np.sort((np.asarray(jix.lists) >= 0).sum(1))
    cap = -(-int(lens[-4:].sum()) // 128) * 128        # covers any 4 cells
    dj, ij = _jax_scan(jix, q, 40, lut_dtype, scan_cap=cap)
    dt, it = _torch_scan(tix, q, 40, lut_dtype, scan_cap=cap)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    _, ip = _torch_scan(tix, q, 40, lut_dtype)
    np.testing.assert_array_equal(it, ip)


@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
def test_kernel_backend_on_cpu_takes_the_plain_version(bridged, lut_dtype):
    _, tix, q = bridged
    dk, ik = _torch_scan(tix, q, 40, lut_dtype, backend="kernel")
    dp, ip = _torch_scan(tix, q, 40, lut_dtype, backend="jnp")
    np.testing.assert_array_equal(ik, ip)
    np.testing.assert_array_equal(dk, dp)


def test_lut_stats_match_jax(bridged):
    jix, tix, q = bridged
    cj, sj = jivfpq.ivfpq_lut_stats(jix.codebooks, jix.cbnorm,
                                    jnp.asarray(q), "int8")
    ct, st = tivfpq.ivfpq_lut_stats(tix.codebooks, tix.cbnorm,
                                    torch.from_numpy(q), "int8")
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)


def test_build_ivfpq_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tivfpq.build_ivfpq(torch.zeros(10, 4), 2, 2, 4)
