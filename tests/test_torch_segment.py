"""The port's deterministic segment sum (repro_torch._segment: the card's
fixed-order one-hot sum, run here on the CPU) against index_add_, and
the k-means and UMAP fits that use it: k-means against
repro.search.ivf.kmeans from the same starting rows; on the card (gpu
tests only), two k-means builds and two UMAP fits equal bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch._device import cpu_generator  # noqa: E402
from repro_torch import _segment  # noqa: E402
from repro_torch._segment import SegmentSum, onehot_segment_sum, \
    segment_sum  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.search import ivf  # noqa: E402


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu tests alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.search import ivf as jivf
    return jax, jivf


def _corpus(seed, n, d, n_clusters=12):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 4.0
    lab = rng.integers(0, n_clusters, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("n,segs,width", [(1, 1, 3), (50, 7, 1), (5000, 33, 4),
                                          (20_000, 1024, 2), (300, 2, 38)])
def test_segment_sum_equals_index_add_on_integers(n, segs, width):
    """Small integers: every product and sum exact, so the order does not
    show and the card's one-hot sum agrees with index_add_ bit for bit
    (empty segments stay 0); on the CPU segment_sum is index_add_."""
    rng = np.random.default_rng(n + segs)
    v = torch.from_numpy(rng.integers(-8, 9, (n, width)).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, segs, n))
    want = torch.zeros((segs, width)).index_add_(0, s, v)
    assert torch.equal(onehot_segment_sum(v, s, segs), want)
    assert torch.equal(segment_sum(v, s, segs), want)


def test_segment_sum_keeps_trailing_shape_and_dtype():
    v = torch.arange(24, dtype=torch.float64).reshape(6, 2, 2)
    s = torch.tensor([0, 2, 2, 0, 1, 2])
    out = onehot_segment_sum(v, s, 4)
    assert out.shape == (4, 2, 2) and out.dtype == torch.float64
    assert torch.equal(out, torch.zeros(4, 2, 2, dtype=torch.float64)
                       .index_add_(0, s, v))


def test_segment_sum_float_data_within_rounding():
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(size=(40_000, 16)).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, 100, 40_000))
    got = onehot_segment_sum(v, s, 100)
    want = torch.zeros((100, 16), dtype=torch.float64).index_add_(
        0, s, v.double())
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-4)


def test_segment_sum_adds_into_a_base_as_jax_scatter_add_does():
    """With a base, the CPU route is base.index_add (JAX's .at[].add order,
    which the UMAP epochs had before), bit for bit on float data; the
    card's route (f64 one-hot sums, kept chunks or not) rounds once and
    stays within the f32 rounding of the base."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.normal(size=(3000, 5)).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, 70, 3000))
    base = torch.from_numpy(rng.normal(size=(70, 5)).astype(np.float32))
    add = SegmentSum(s, 70)
    assert torch.equal(add(v, base), base.index_add(0, s, v))
    assert torch.equal(add(v), torch.zeros(70, 5).index_add_(0, s, v))
    onehots = list(_segment._onehot_chunks(s, 70))
    got = onehot_segment_sum(v, s, 70, base, onehots=onehots)
    assert torch.equal(got, onehot_segment_sum(v, s, 70, base))
    want = base.double().index_add(0, s, v.double())
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,d,nlist,iters", [(2400, 16, 16, 12),
                                             (3000, 8, 40, 5)])
def test_kmeans_matches_jax_from_the_same_rows(n, d, nlist, iters):
    """The port's kmeans from JAX's own starting rows (jax.random.choice of
    the same key) against repro.search.ivf.kmeans: the cluster sums in
    other orders (row order on the CPU against one whole one-hot matmul),
    the tolerance of the ivfpq build's centroids."""
    jax, jivf = _jax()
    x = _corpus(n, n, d)
    key = jax.random.key(5)
    init = np.array(jax.random.choice(key, n, (nlist,), replace=False))
    want = np.asarray(jivf.kmeans(key, jax.numpy.asarray(x), nlist, iters))
    got = ivf.kmeans(torch.from_numpy(x), nlist, iters,
                     init=torch.from_numpy(init).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_umap_fit_repeats_on_the_cpu():
    x = torch.from_numpy(_corpus(0, 120, 12))
    a = baselines.fit_umap_lite(x, 3, epochs=3, generator=cpu_generator(1))
    b = baselines.fit_umap_lite(x, 3, epochs=3, generator=cpu_generator(1))
    assert torch.equal(a(x), b(x))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kmeans_repeats_bit_for_bit():
    """Two k-means runs on one input on the card: the same centroids, bit
    for bit (index_add_'s float atomics did not repeat)."""
    dev = _cuda()
    x = torch.from_numpy(_corpus(1, 200_000, 64, n_clusters=300)).to(dev)
    init = torch.randperm(x.shape[0], generator=cpu_generator(0))[:1024]
    a = ivf.kmeans(x, 1024, 6, init=init)
    b = ivf.kmeans(x, 1024, 6, init=init)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [200_000, 400_000])
def test_cuda_segment_sum_ignores_the_tf32_setting(n):
    """The card's sums are f64 products, which no TF32 setting rounds:
    with TF32 allowed (where a plain f32 matmul does change) the sum
    equals the run with it off, bit for bit, and the CPU's f64 index_add_
    to the f32 rounding; the caller's setting is left as it was. 200k rows
    x 1024 segments keep their one-hot chunks (1.6 GB), 400k make them
    anew. (k-means's assignment is a plain f32 matmul and follows the
    setting, as any matmul of the caller's does.)"""
    dev = _cuda()
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, 1024, n))
    vd, sd = v.to(dev), s.to(dev)
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_tf32
    try:
        sums, grams = [], []
        for tf32 in (False, True):
            matmul.allow_tf32 = tf32
            sums.append(segment_sum(vd, sd, 1024))
            grams.append(vd[:4096].T @ vd[:4096])
            assert matmul.allow_tf32 == tf32
    finally:
        matmul.allow_tf32 = was
    assert not torch.equal(grams[0], grams[1])      # TF32 really was on
    assert torch.equal(sums[0], sums[1])
    want = torch.zeros((1024, 32), dtype=torch.float64).index_add_(
        0, s, v.double())
    torch.testing.assert_close(sums[1].cpu().double(), want, rtol=0,
                               atol=1e-5)


@pytest.mark.gpu
def test_cuda_umap_fit_repeats_bit_for_bit():
    dev = _cuda()
    x = torch.from_numpy(_corpus(2, 2048, 64)).to(dev)
    emb = [baselines.fit_umap_lite(x, 8, epochs=20,
                                   generator=cpu_generator(3))(x)
           for _ in range(2)]
    assert torch.equal(emb[0], emb[1])
