"""Port parity: the plain version of kernel K3 (exact L2 k-NN top-k)
against repro.kernels.knn_topk's knn_ref and, in interpret mode,
knn_topk_pallas; the wrappers' CPU contract; the build's header hashing;
and the CUDA kernel against its plain version (on the card only)."""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import knn_topk as kt  # noqa: E402
from repro_torch.kernels.knn_topk import ops  # noqa: E402

# d2 tolerance: both packages compute |q|^2 + |x|^2 - 2 q.x in f32 from the
# same inputs, with the sums in other orders (torch's CPU matmul against
# XLA's, or the TPU kernel's blocks); on rows of norm ~sqrt(D) the terms
# reach ~2D, a few ulps of which is ~1e-5 relative
RTOL, ATOL = 1e-5, 1e-5


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu test alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.knn_topk import knn_ref, knn_topk_pallas
    return jax.numpy, knn_ref, knn_topk_pallas


def _inputs(seed, nq, n, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nq, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _tol(q, x):
    """Per-query d2 tolerance, relative to the magnitude of the summands."""
    qq = (q.astype(np.float64) ** 2).sum(1)
    return RTOL * (qq + (x.astype(np.float64) ** 2).sum(1).max()) + ATOL


def _assert_same_neighbours(dt, it, dj, ij, tol):
    """d2 within ``tol`` (per query), and the ids equal wherever the
    reference's d2 is more than ``tol`` below its k-th: near-ties at the
    cut may keep other rows, and within the list may swap places."""
    dt, it, dj, ij = map(np.asarray, (dt, it, dj, ij))
    assert (np.abs(dt - dj) <= tol[:, None]).all(), np.abs(dt - dj).max()
    kth = dj[:, -1:]
    clear = dj < kth - tol[:, None]
    for r in range(dj.shape[0]):
        assert set(ij[r][clear[r]]) <= set(it[r]), r
        # ids whose d2 stands apart from its neighbours' sit in place
        d = dj[r]
        apart = np.ones_like(d, bool)
        gaps = np.diff(d) > tol[r]
        apart[1:] &= gaps
        apart[:-1] &= gaps
        np.testing.assert_array_equal(it[r][apart & clear[r]],
                                      ij[r][apart & clear[r]])


@pytest.mark.parametrize("nq,n,d,k", [(32, 200, 8, 5), (130, 1000, 32, 10),
                                      (7, 333, 17, 3), (5, 40, 384, 40),
                                      (64, 777, 38, 15), (1, 50, 1, 7)])
def test_plain_matches_jax_ref(nq, n, d, k):
    jnp, knn_ref, _ = _jax()
    q, x = _inputs(nq * 7 + n, nq, n, d)
    dj, ij = knn_ref(jnp.asarray(q), jnp.asarray(x), k)
    dt, it = kt.knn_ref(torch.from_numpy(q), torch.from_numpy(x), k)
    assert dt.dtype == torch.float32 and it.dtype == torch.int64
    _assert_same_neighbours(dt, it, dj, ij, _tol(q, x))


def test_plain_ties_go_to_the_lower_row():
    """Small-integer data: every d2 is exact in both packages, so the ids
    are equal, ties included (the order of lax.top_k)."""
    jnp, knn_ref, _ = _jax()
    rng = np.random.default_rng(3)
    q = rng.integers(-2, 3, (40, 5)).astype(np.float32)
    x = rng.integers(-2, 3, (500, 5)).astype(np.float32)
    x[250:] = x[:250]                                 # duplicate rows
    dj, ij = knn_ref(jnp.asarray(q), jnp.asarray(x), 30)
    dt, it = kt.knn_ref(torch.from_numpy(q), torch.from_numpy(x), 30)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (np.diff(dt.numpy(), axis=1) == 0).sum() > 100   # real ties


@pytest.mark.parametrize("nq,n,d,k", [(32, 200, 8, 5), (70, 333, 17, 12),
                                      (7, 64, 4, 16)])
def test_plain_matches_interpret_mode_pallas(nq, n, d, k):
    """The TPU kernel in interpret mode: its running extract-min keeps the
    first slot holding the worst value and its final argsort orders ties by
    slot, so among rows tied at the k-th distance it may keep another one.
    Distances agree; ids agree strictly below the k-th distance."""
    jnp, _, knn_topk_pallas = _jax()
    q, x = _inputs(nq + n, nq, n, d)
    dj, ij = knn_topk_pallas(jnp.asarray(q), jnp.asarray(x), k, block_q=32,
                             block_n=64)
    dt, it = kt.knn_topk_d2(torch.from_numpy(q), torch.from_numpy(x), k)
    _assert_same_neighbours(dt, it, dj, ij, _tol(q, x))


def test_plain_matches_interpret_mode_pallas_bf16():
    """bf16 inputs: both widen to f32 before any arithmetic."""
    jnp, _, knn_topk_pallas = _jax()
    q, x = _inputs(11, 45, 300, 16)
    qb = torch.from_numpy(q).bfloat16()
    xb = torch.from_numpy(x).bfloat16()
    dj, ij = knn_topk_pallas(jnp.asarray(qb.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        8, block_q=32, block_n=64)
    dt, it = kt.knn_topk_d2(qb, xb, 8)
    _assert_same_neighbours(dt, it, dj, ij,
                            _tol(qb.float().numpy(), xb.float().numpy()))


def test_wrapper_pads_past_n_and_takes_the_square_root():
    q, x = _inputs(1, 6, 5, 3)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    before = (ops.knn_topk_d2.launches, ops.knn_topk.launches)
    d2, i2 = kt.knn_topk_d2(qt, xt, 8)
    assert torch.isinf(d2[:, 5:]).all() and (i2[:, 5:] == -1).all()
    assert (i2[:, :5] >= 0).all()
    dr, ir = kt.knn_ref(qt, xt, 5)
    assert torch.equal(d2[:, :5], dr) and torch.equal(i2[:, :5], ir)
    d1, i1 = kt.knn_topk(qt, xt, 8)
    assert torch.equal(i1, i2) and torch.equal(d1, d2.clamp_min(0).sqrt())
    # the plain route launches nothing
    assert (ops.knn_topk_d2.launches, ops.knn_topk.launches) == before
    empty_d, empty_i = kt.knn_topk_d2(qt, xt[:0], 3)
    assert torch.isinf(empty_d).all() and (empty_i == -1).all()


def test_wrapper_checks_its_arguments():
    qt = torch.zeros((4, 3))
    xt = torch.zeros((9, 3))
    for k in (0, -1):
        with pytest.raises(ValueError, match="at least 1"):
            kt.knn_topk_d2(qt, xt, k)
    with pytest.raises(ValueError, match="expected q"):
        kt.knn_topk_d2(qt, torch.zeros((9, 4)), 2)
    with pytest.raises(ValueError, match="no kernel"):
        kt.knn_topk_d2(qt.to("meta"), xt.to("meta"), 2)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Both routes take what the kernel takes: contiguous inputs of one
    dtype, f32 or bf16 (any k >= 1 since the kernel serves any k)."""
    qt = torch.zeros((4, 3))
    xt = torch.zeros((9, 3))
    with pytest.raises(ValueError, match="contiguous"):
        kt.knn_topk_d2(torch.zeros((3, 4)).T, xt, 2)
    with pytest.raises(TypeError, match="both"):
        kt.knn_topk_d2(qt, xt.to(torch.bfloat16), 2)
    with pytest.raises(TypeError, match="both"):
        kt.knn_topk_d2(qt.double(), xt.double(), 2)


def test_library_hash_covers_included_headers(tmp_path):
    """K3 includes pq_adc/csrc/topk_select.cuh: its library name follows
    an edit of that header, as K1's and K2's do."""
    src = build.SOURCES
    k3 = next(s for s in src if s.name == "knn_topk.cu")
    assert [h.name for h in build.local_headers(k3)] == ["topk_select.cuh"]
    kernels = tmp_path / "kernels"
    shutil.copytree(k3.parents[2], kernels)
    copy = kernels / "knn_topk" / "csrc" / "knn_topk.cu"
    header = kernels / "pq_adc" / "csrc" / "topk_select.cuh"
    first = build.library_path(copy).name
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(copy).name != first
    # K1-K6, one each, and K5's and K6's f32 routes beside their bf16 ones
    assert k3 in src and len(src) == 8


@pytest.mark.gpu
@pytest.mark.parametrize("nq,n,d,k", [(1, 5003, 38, 10), (100, 5003, 19, 15),
                                      (130, 1, 64, 1), (7, 50, 384, 50),
                                      (3, 20_000, 64, 512),
                                      (257, 3000, 38, 200),
                                      (40, 20_000, 64, 513),
                                      (5, 20_000, 38, 4096),
                                      (17, 700, 19, 703),
                                      (3, 20_000, 64, 9000),
                                      (2, 8500, 38, 9000)])
def test_cuda_kernel_matches_plain_version(nq, n, d, k):
    """K3 on the card against its plain version on the same CUDA inputs:
    small-integer data, so every product and sum is exact and d2 and ids
    are bit-equal, ties included (Q = 1 and ragged, N = 1 and ragged,
    k = 1, k = N, k 512, 513 and 4096 (lists in shared memory, then in
    global scratch), k 9000 (past the split merge: one split walks the
    database), k = N + 3 and k = 9000 > N (the (inf, -1) padding),
    D = 19, 38, 64, 384)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(nq + n + d)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.integers(-3, 4, (nq, d)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-3, 4, (n, d)).astype(np.float32))
    q, x = q.to(dev), x.to(dev)
    for dt in (torch.float32, torch.bfloat16):
        before = ops.knn_topk_d2.launches
        dk, ik = kt.knn_topk_d2(q.to(dt), x.to(dt), k)
        torch.cuda.synchronize()
        assert ops.knn_topk_d2.launches == before + 1
        dp, ip = kt.knn_topk_plain(q.to(dt), x.to(dt), k)
        assert torch.equal(dk, dp)
        assert torch.equal(ik, ip)


@pytest.mark.gpu
@pytest.mark.parametrize("nq,n,d,k", [(37, 5000, 38, 2000),
                                      (5, 3000, 64, 3100)])
def test_cuda_kernel_runs_queries_in_halves_past_the_scratch_cap(
        monkeypatch, nq, n, d, k):
    """A call whose k-best lists need more scratch than ``_SCRATCH_CAP``
    runs its queries in halves, down to one query a launch: with the cap
    at one byte every query goes alone, and the result is still bit-equal
    to the plain version (one counted launch, the (inf, -1) padding past
    N included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(ops, "_SCRATCH_CAP", 1)
    calls, launch = [], ops._launch

    def counted(lib, q, *rest):
        calls.append(q.shape[0])
        return launch(lib, q, *rest)

    monkeypatch.setattr(ops, "_launch", counted)
    rng = np.random.default_rng(nq + k)
    q, x = (torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
            .cuda() for shape in ((nq, d), (n, d)))
    before = ops.knn_topk_d2.launches
    dk, ik = kt.knn_topk_d2(q, x, k)
    torch.cuda.synchronize()
    assert ops.knn_topk_d2.launches == before + 1
    # halved down to single queries: a binary tree of 2 Q - 1 calls
    assert len(calls) == 2 * nq - 1 and calls.count(1) == nq
    dp, ip = kt.knn_topk_plain(q, x, k)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
