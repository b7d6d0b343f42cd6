"""Port parity: IVF-PQ build and scans (repro_torch.search.ivfpq) against
repro.search.ivfpq on the same numpy inputs. The build is fed JAX's own
k-means starting rows; the scans run on a JAX-built index carried across
by repro_torch.bridge.state_from_arrays. The kernel backend's padded scan
goes through K1's cell-major entry (its plain version here; the kernel on
the card, in the gpu-marked test)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.bridge import state_from_arrays  # noqa: E402
from repro_torch.kernels.pq_adc import ops as adc_ops  # noqa: E402
from repro_torch.search import ivfpq as tivfpq  # noqa: E402

N, D, NLIST, M, K = 2400, 16, 16, 4, 64


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu test alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.search import build_engine
    from repro.search import ivfpq
    return jax, jax.numpy, build_engine, ivfpq


def _corpus(seed, n, d=D, n_clusters=12):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 4.0
    lab = rng.integers(0, n_clusters, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


def _jax_inits(key, n):
    """The starting rows JAX's build_ivfpq draws: coarse k-means from
    ``key``, subspace m's codebook from fold_in(fold_in(key, 7), m)."""
    jax = _jax()[0]
    coarse = jax.random.choice(key, n, (NLIST,), replace=False)
    pq_key = jax.random.fold_in(key, 7)
    pq = [jax.random.choice(jax.random.fold_in(pq_key, m), n, (min(K, n),),
                            replace=False) for m in range(M)]
    return (torch.from_numpy(np.asarray(coarse)).long(),
            torch.from_numpy(np.stack([np.asarray(p) for p in pq])).long())


@pytest.fixture(scope="module")
def built():
    jax, jnp, _, jivfpq = _jax()
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
    jax, _, jax_build_engine, _ = _jax()
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
    jax, jnp, _, jivfpq = _jax()
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


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_masked_scan_matches_jax_live(bridged, lut_dtype):
    """The streaming scan's tombstone mask: ivfpq_adc_scan(..., live=)
    against JAX's with the same (N,) live map, on the plain route and on
    K1's cell-major entry (fills with a live byte map; its plain version
    here): ids equal up to near-ties, d2 within rtol 1e-5, and the two
    routes bit-equal."""
    jax, jnp, _, jivfpq = _jax()
    jix, tix, q = bridged
    live = np.random.default_rng(3).uniform(size=N) >= 0.25
    dj, ij = jax.jit(functools.partial(
        jivfpq.ivfpq_adc_scan, n_cand=40, nprobe=4, backend="jnp",
        lut_dtype=lut_dtype))(jix.centroids, jix.lists, jix.codes_cell,
                              jix.bias_cell, jix.lut_w, jix.cbnorm,
                              jix.codebooks, jnp.asarray(q),
                              live=jnp.asarray(live))
    dj, ij = np.asarray(dj), np.asarray(ij)
    assert not np.isin(ij, np.nonzero(~live)[0]).any()
    args = (tix.centroids, tix.lists, tix.codes_cell, tix.bias_cell,
            tix.lut_w, tix.cbnorm, tix.codebooks, torch.from_numpy(q), 40, 4)
    out = {b: tivfpq.ivfpq_adc_scan(*args, backend=b, lut_dtype=lut_dtype,
                                    live=torch.from_numpy(live))
           for b in ("jnp", "kernel")}
    # a near-tie may swap two ids: the tables and the int8 centre are
    # formed in another order than XLA's, a ulp apart
    it = out["jnp"][1].numpy()
    for r, c in zip(*np.nonzero(it != ij)):
        at = np.nonzero(ij[r] == it[r, c])[0]
        assert at.size == 1 and abs(dj[r, at[0]] - dj[r, c]) <= 1e-5 * abs(
            dj[r, c]), (r, c)
    assert (it != ij).mean() <= 1e-2
    np.testing.assert_allclose(out["jnp"][0].numpy(), dj, rtol=1e-5)
    assert torch.equal(out["kernel"][0], out["jnp"][0])
    assert torch.equal(out["kernel"][1], out["jnp"][1])


def test_live_cells_marks_the_live_posting_slots(bridged):
    """``live_cells`` maps the (N,) live mask onto the posting lists: 1
    exactly where a slot holds a live row; pads and dead rows 0. Through
    ``ref.live_slots`` it masks a probed slot as the row's id would."""
    from repro_torch.kernels.pq_adc.ref import live_slots
    _, tix, q = bridged
    live = np.random.default_rng(4).uniform(size=N) >= 0.3
    cells = tivfpq.live_cells(tix.lists, torch.from_numpy(live))
    lists = tix.lists.numpy()
    assert cells.dtype == torch.uint8 and cells.shape == tix.lists.shape
    want = (lists >= 0) & live[np.clip(lists, 0, N - 1)]
    np.testing.assert_array_equal(cells.numpy(), want.astype(np.uint8))
    probe, cand, _ = tivfpq.probe_cells(tix.centroids, tix.lists,
                                        torch.from_numpy(q), 4, 40)
    for width in (cand.shape[1], cand.shape[1] - 5, cand.shape[1] + 7):
        got = live_slots(probe, cells, width).numpy()
        c = np.pad(cand.numpy(), ((0, 0), (0, max(0, width - cand.shape[1]))),
                   constant_values=-1)[:, :width]
        np.testing.assert_array_equal(
            got, (c >= 0) & live[np.clip(c, 0, N - 1)])


def test_lut_stats_match_jax(bridged):
    _, jnp, _, jivfpq = _jax()
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


def _left_packed(lists):
    valid = np.asarray(lists) >= 0
    return bool((valid[:, 1:] <= valid[:, :-1]).all())


def test_posting_lists_are_left_packed(built, bridged):
    """The padded scan hands K1 each cell's fill, (lists >= 0).sum(1), in
    place of the candidate ids: right only for left-packed lists (a cell's
    ids, then -1 pads). The port's build, JAX's build and the bridge all
    give them; a list with a hole is caught by the check."""
    _, jidx, tidx = built
    _, tix, _ = bridged
    for lists in (tidx.lists.numpy(), np.asarray(jidx.lists),
                  tix.lists.numpy()):
        assert _left_packed(lists)
    holed = tidx.lists.numpy().copy()
    row = int(np.argmax((holed >= 0).sum(1)))
    holed[row, 0] = -1
    assert not _left_packed(holed)


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_cells_scan_matches_jax_given_probe(bridged, lut_dtype):
    """The kernel backend's padded scan (K1's cell-major entry, its plain
    version on the CPU), reading the candidate ids and the cells' fills,
    against JAX's ivfpq_scan_given_probe on JAX's own probe: ids equal, d2
    within rtol 1e-5 (the tables and the int8 centre are formed in another
    order than XLA's, as in test_padded_scan_matches_jax; on the same
    tables K1's output is bit-equal at int8: the next test)."""
    jax, jnp, _, jivfpq = _jax()
    from repro.search.ivf import probe_cells as jax_probe_cells
    jix, tix, q = bridged
    probe, cand, cd2p = jax.jit(functools.partial(
        jax_probe_cells, nprobe=4, min_cand=40))(jix.centroids, jix.lists,
                                                 jnp.asarray(q))
    dj, ij = jax.jit(functools.partial(
        jivfpq.ivfpq_scan_given_probe, n_cand=40, backend="jnp",
        lut_dtype=lut_dtype))(probe, cand, cd2p, jix.codes_cell,
                              jix.bias_cell, jix.lut_w, jix.cbnorm,
                              jix.codebooks, jnp.asarray(q))
    dj, ij = np.asarray(dj), np.asarray(ij)
    args = (torch.from_numpy(np.asarray(probe)).long(),
            torch.from_numpy(np.asarray(cand)),
            torch.from_numpy(np.asarray(cd2p)), tix.codes_cell,
            tix.bias_cell, tix.lut_w, tix.cbnorm, tix.codebooks,
            torch.from_numpy(q), 40)
    for cell_len in (None, (tix.lists >= 0).sum(dim=1)):
        dt, it = tivfpq.ivfpq_scan_given_probe(*args, backend="kernel",
                                               lut_dtype=lut_dtype,
                                               cell_len=cell_len)
        np.testing.assert_array_equal(it.numpy(), ij)
        np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5)


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_cells_entry_matches_jax_on_the_scan_inputs(bridged, lut_dtype):
    """K1's cell-major entry (its plain version on the CPU) on the bridged
    index's cells, with JAX's own probe, tables and int8 centre and scale,
    against JAX's gathered reference on JAX's gather of the same scan: ids
    equal below the k-th score, int8 d2 bit-equal, f32 / bf16 d2 within
    rtol 1e-6 (the M-term sum runs in another order than XLA's)."""
    jax, jnp, _, jivfpq = _jax()
    from repro.kernels.pq_adc.ref import pq_adc_gather_topk_ref
    from repro.search.ivf import probe_cells as jax_probe_cells
    from repro.search.pq import adc_tables
    jix, tix, q = bridged
    qj = jnp.asarray(q)
    probe, cand, cd2p = jax_probe_cells(jix.centroids, jix.lists, qj, 4, 40)
    tables = adc_tables(jix.lut_w, jix.cbnorm, qj)
    scale = None
    if lut_dtype == "int8":
        center, scale = jivfpq.ivfpq_lut_stats(jix.codebooks, jix.cbnorm,
                                               qj, "int8")
        tables = tables - center[:, :, None]
    nq, max_cell = q.shape[0], jix.codes_cell.shape[1]
    ccodes = jix.codes_cell[probe].reshape(nq, -1, M)
    base = jnp.repeat(cd2p, max_cell, axis=1) + jix.bias_cell[probe].reshape(
        nq, -1)
    base = jnp.where(cand >= 0, base, jnp.inf)
    dj, ij = pq_adc_gather_topk_ref(tables, ccodes, base, 40,
                                    lut_dtype=lut_dtype, scale=scale)
    dj, ij = np.asarray(dj), np.asarray(ij)
    t = lambda a: torch.from_numpy(np.asarray(a))
    for cell_len in (None, (tix.lists >= 0).sum(dim=1)):
        dt, it = adc_ops.pq_adc_cells_topk(
            t(tables), t(probe).long(), t(cd2p), tix.codes_cell,
            tix.bias_cell, t(cand), 40, lut_dtype,
            None if scale is None else t(scale), cell_len)
        below = dj < dj[:, -1:]
        np.testing.assert_array_equal(it.numpy()[below], ij[below])
        if lut_dtype == "int8":
            np.testing.assert_array_equal(dt.numpy().view(np.uint32),
                                          dj.view(np.uint32))
        else:
            np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
def test_cuda_padded_scan_takes_the_cells_entry(lut_dtype):
    """On the card the kernel backend's padded scan launches K1's
    cell-major entry once (and the gathered entry never), the compact scan
    the gathered entry once; both return the ids of the plain route
    (``@jnp``), int8 d2 bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_corpus(3, N)).cuda()
    ix = tivfpq.build_ivfpq(x, NLIST, M, K, device="cuda", generator=gen)
    q = torch.from_numpy(_corpus(4, 64)).cuda()
    args = (ix.centroids, ix.lists, ix.codes_cell, ix.bias_cell, ix.lut_w,
            ix.cbnorm, ix.codebooks, q, 40, 4)
    g0, c0 = (adc_ops.pq_adc_gather_topk.launches,
              adc_ops.pq_adc_cells_topk.launches)
    dk, ik = tivfpq.ivfpq_adc_scan(*args, backend="kernel",
                                   lut_dtype=lut_dtype)
    torch.cuda.synchronize()
    assert (adc_ops.pq_adc_gather_topk.launches - g0,
            adc_ops.pq_adc_cells_topk.launches - c0) == (0, 1)
    dp, ip = tivfpq.ivfpq_adc_scan(*args, backend="jnp", lut_dtype=lut_dtype)
    assert torch.equal(ik, ip)
    if lut_dtype == "int8":
        assert torch.equal(dk, dp)
    cap = -(-int((ix.lists >= 0).sum(1).sort().values[-4:].sum()) // 128) * 128
    g0 = adc_ops.pq_adc_gather_topk.launches
    _, ic = tivfpq.ivfpq_compact_scan(*args, scan_cap=cap, backend="kernel",
                                      lut_dtype=lut_dtype)
    torch.cuda.synchronize()
    assert adc_ops.pq_adc_gather_topk.launches == g0 + 1
    assert torch.equal(ic, ip)
