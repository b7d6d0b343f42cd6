"""Port parity for the exact searches and the paper's A_m(k): knn_search,
knn_search_blocked (ragged blocks, k > N, the +inf padding rows) and
amk_accuracy against repro.search.knn on the same numpy inputs; on the card
(gpu tests only), knn_scan and knn_search_blocked launch kernel K3."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels.knn_topk import ops as k3  # noqa: E402
from repro_torch.search import knn  # noqa: E402

# distances (not squared): both packages take sqrt of the same clamped f32
# d2, whose sums run in another order (torch's CPU matmul against XLA's)
RTOL, ATOL = 1e-5, 1e-5


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu tests alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.search import knn as jknn
    return jax.numpy, jknn


def _data(seed, nq, n, d, zeros=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if zeros:                      # q @ inf on a padding row is NaN there
        q[:, ::3] = 0.0
    return q, x


def _assert_search_equal(dt, it, dj, ij):
    """Distances within tolerance; ids equal (these inputs have no
    near-ties at the resolution of the tolerance)."""
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("nq,n,d,k", [(9, 300, 16, 10), (1, 5, 7, 8),
                                      (33, 1000, 38, 15)])
def test_knn_search_matches_jax(nq, n, d, k):
    """k > N pads (inf, -1) in both."""
    jnp, jknn = _jax()
    q, x = _data(nq + n, nq, n, d)
    dj, ij = jknn.knn_search(jnp.asarray(q), jnp.asarray(x), k)
    dt, it = knn.knn_search(torch.from_numpy(q), torch.from_numpy(x), k)
    _assert_search_equal(dt, it, dj, ij)


@pytest.mark.parametrize("nq,n,d,k,block", [
    (9, 300, 16, 10, 64),          # ragged last block
    (5, 256, 8, 20, 128),          # whole blocks
    (4, 7, 6, 10, 4),              # k > N: pads (inf, 0)
    (6, 50, 9, 30, 16),            # k > block
    (3, 100, 12, 5, 1024),         # one block, mostly padding
])
def test_knn_search_blocked_matches_jax(nq, n, d, k, block):
    jnp, jknn = _jax()
    q, x = _data(nq * n + block, nq, n, d, zeros=True)
    dj, ij = jknn.knn_search_blocked(jnp.asarray(q), jnp.asarray(x), k,
                                     block=block)
    dt, it = knn.knn_search_blocked(torch.from_numpy(q), torch.from_numpy(x),
                                    k, block=block)
    _assert_search_equal(dt, it, dj, ij)
    if k > n:
        assert torch.isinf(dt[:, n:]).all() and (it[:, n:] == 0).all()


@pytest.mark.parametrize("nq,n,d,k", [(6, 900, 12, 600), (5, 40, 9, 45),
                                      (3, 700, 38, 705)])
def test_large_k_matches_jax(nq, n, d, k):
    """Any k >= 1, as JAX's knn_scan serves it (k 600, and k = N + 5): the
    K3 wrapper's plain route and knn_scan pad (inf, -1), and
    knn_search_blocked (inf, 0), against repro.search.knn."""
    jnp, jknn = _jax()
    q, x = _data(nq + n + k, nq, n, d)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    dj, ij = jknn.knn_scan(jnp.asarray(q), jnp.asarray(x), k)
    dt, it = knn.knn_scan(qt, xt, k)
    _assert_search_equal(dt, it, dj, ij)
    d2, i2 = k3.knn_topk_d2(qt, xt, k)
    _assert_search_equal(d2.clamp_min(0).sqrt(), i2, dj, ij)
    if k > n:
        assert (it[:, n:] == -1).all() and (i2[:, n:] == -1).all()
    dj, ij = jknn.knn_search_blocked(jnp.asarray(q), jnp.asarray(x), k,
                                     block=256)
    dt, it = knn.knn_search_blocked(qt, xt, k, block=256)
    _assert_search_equal(dt, it, dj, ij)


def test_blocked_and_full_search_agree_below_n():
    q, x = _data(4, 20, 500, 24)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    d1, i1 = knn.knn_search(qt, xt, 12)
    d2, i2 = knn.knn_search_blocked(qt, xt, 12, block=96)
    assert torch.equal(i1, i2)
    torch.testing.assert_close(d1, d2, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block", [None, 128])
@pytest.mark.parametrize("k", [1, 6, 15])
def test_amk_accuracy_matches_jax(k, block):
    """The same affine reducer (a fixed random projection) in both
    packages, given as a callable and as an object with .transform."""
    jnp, jknn = _jax()
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(12, 40)) * 2.0
    x = (centers[rng.integers(0, 12, 600)]
         + rng.normal(size=(600, 40))).astype(np.float32)
    y = (centers[rng.integers(0, 12, 80)]
         + rng.normal(size=(80, 40))).astype(np.float32)
    mat = rng.normal(size=(40, 8)).astype(np.float32)
    aj = float(jknn.amk_accuracy(lambda v: v @ jnp.asarray(mat),
                                 jnp.asarray(x), jnp.asarray(y), k,
                                 block=block))

    class Proj:
        def transform(self, v):
            return v @ torch.from_numpy(mat)

    for red in (lambda v: v @ torch.from_numpy(mat), Proj()):
        at = knn.amk_accuracy(red, torch.from_numpy(x), torch.from_numpy(y),
                              k, block=block)
        assert isinstance(at, float)
        # a neighbour flip at a near-tie moves the mean by 1 / (80 k)
        assert abs(at - aj) <= 2.0 / (80 * k) + 1e-12, (at, aj)
    # the identity keeps every neighbour
    assert knn.amk_accuracy(lambda v: v, torch.from_numpy(x),
                            torch.from_numpy(y), k, block=block) == 1.0


def test_recall_at_k_matches_jax():
    jnp, jknn = _jax()
    rng = np.random.default_rng(2)
    found = rng.integers(0, 30, (50, 10))
    truth = rng.integers(0, 30, (50, 10))
    rj = float(jknn.recall_at_k(jnp.asarray(found), jnp.asarray(truth)))
    rt = knn.recall_at_k(torch.from_numpy(found), torch.from_numpy(truth))
    assert abs(rt - rj) < 1e-6


@pytest.mark.gpu
def test_cuda_exact_searches_launch_k3():
    """On the card knn_scan, knn_search and knn_search_blocked are kernel
    K3 (one launch each; the blocked scan keeps its (inf, 0) padding), and
    amk_accuracy launches it twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    q, x = _data(0, 33, 2000, 38)
    qc, xc = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
    n0 = k3.knn_topk_d2.launches
    d, i = knn.knn_scan(qc, xc, 15)
    torch.cuda.synchronize()
    assert k3.knn_topk_d2.launches == n0 + 1
    dp, ip = knn.knn_scan(qc.cpu(), xc.cpu(), 15)
    torch.testing.assert_close(d.cpu(), dp, rtol=RTOL, atol=ATOL)
    assert (i.cpu() == ip).float().mean() > 0.99
    _, i5 = knn.knn_search_blocked(qc, xc[:5], 8)
    assert k3.knn_topk_d2.launches == n0 + 2
    assert (i5[:, 5:] == 0).all()
    knn.knn_search(qc, xc, 3)
    assert k3.knn_topk_d2.launches == n0 + 3
    acc = knn.amk_accuracy(lambda v: v[:, :19].contiguous(), xc, qc, 10)
    assert k3.knn_topk_d2.launches == n0 + 5 and 0.0 <= acc <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1024, 2003])
def test_cuda_large_k_scan_matches_plain(k):
    """knn_scan on the card at k past what shared memory holds (K3's lists
    in global scratch) and at k = N + 3: one K3 launch, ids equal to the
    plain version's and (inf, -1) past N."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(k)
    q = torch.from_numpy(rng.integers(-3, 4, (70, 24)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-3, 4, (2000, 24)).astype(np.float32))
    q, x = q.to(dev), x.to(dev)
    n0 = k3.knn_topk_d2.launches
    d, i = knn.knn_scan(q, x, k)
    torch.cuda.synchronize()
    assert k3.knn_topk_d2.launches == n0 + 1
    dp, ip = k3.knn_topk_plain(q, x, k)
    assert torch.equal(i, ip) and torch.equal(d, dp.sqrt())
    if k > 2000:
        assert (i[:, 2000:] == -1).all()
