"""Port parity for the baseline reducers (repro_torch.core.baselines)
against repro.core.baselines: each fitted on the same numpy data, with
JAX's random draws fed in (the projection matrix, the Nyström landmarks,
UMAP's negatives), compared on held-out points up to the signs of the
embedding's columns (SVD and eigh choose them), and through A_m(k)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro.search import knn as jknn  # noqa: E402
from repro_torch.bridge import affine_reducer  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.search import knn  # noqa: E402

# embeddings up to column signs, relative to the largest coordinate:
# eigh / SVD of the same f32 matrices in LAPACK builds that differ (XLA's
# and torch's) agree to ~1e-5 on well-separated eigenvalues; the nonlinear
# methods carry that through a geodesic or kernel map (1e-4)
LINEAR_RTOL = 1e-4
NONLINEAR_RTOL = 1e-3
UMAP_EPOCHS = 6          # a few epochs keep the close comparison cheap


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, 32)) * 2.0
    lab = rng.integers(0, 6, 200)
    x = (centers[lab] + 0.3 * rng.normal(size=(200, 32))).astype(np.float32)
    return x[:160], x[160:]


def _aligned(t, j):
    """``t`` with each column's sign flipped to agree with ``j``'s."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    s = np.sign((t * j).sum(axis=0))
    s[s == 0] = 1.0
    return t * s


def _assert_embedding(t, j, rtol):
    t = _aligned(t, j)
    scale = np.abs(j).max()
    err = np.abs(t - np.asarray(j)).max()
    assert err <= rtol * scale, (err, scale)


def _amk_pair(tred, jred, xtr, xte, k):
    at = knn.amk_accuracy(tred, torch.from_numpy(xtr), torch.from_numpy(xte),
                          k)
    aj = float(jknn.amk_accuracy(jred, jnp.asarray(xtr), jnp.asarray(xte),
                                 k))
    return at, aj


def _fits(name, xtr):
    """(port reducer, JAX reducer) fitted on ``xtr`` with the same draws."""
    xj, xt = jnp.asarray(xtr), torch.from_numpy(xtr)
    m = 4
    if name == "pca":
        return tb.fit_pca(xt, m), jb.fit_pca(xj, m)
    if name in ("rp", "rp_achlioptas"):
        kind = "gaussian" if name == "rp" else "achlioptas"
        key = jax.random.key(1)
        draws = (jax.random.normal(key, (32, m)) if kind == "gaussian"
                 else jax.random.uniform(key, (32, m)))
        return (tb.fit_random_projection(None, 32, m, kind,
                                         draws=np.array(draws)),
                jb.fit_random_projection(key, 32, m, kind))
    if name == "mds":
        return tb.fit_mds(xt, m), jb.fit_mds(xj, m)
    if name == "kpca":
        return tb.fit_kpca_rbf(xt, m), jb.fit_kpca_rbf(xj, m)
    if name == "kpca_nystrom":
        key = jax.random.key(3)
        idx = jax.random.choice(key, 160, (80,), replace=False)
        return (tb.fit_kpca_rbf(xt, m, landmarks=80,
                                landmark_idx=np.array(idx)),
                jb.fit_kpca_rbf(xj, m, landmarks=80, key=key))
    if name == "isomap":
        return tb.fit_isomap(xt, 3, k=8), jb.fit_isomap(xj, 3, k=8)
    if name == "umap":
        key = jax.random.key(4)
        n_edges = 160 * 15 * 2
        neg = np.stack([np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(jax.random.fold_in(key, jnp.uint32(ep)), t),
            (n_edges,), 0, 160)) for t in range(5)])
            for ep in range(UMAP_EPOCHS)])
        return (tb.fit_umap_lite(xt, 3, epochs=UMAP_EPOCHS, negatives=neg),
                jb.fit_umap_lite(xj, 3, epochs=UMAP_EPOCHS, key=key))
    raise ValueError(name)


METHODS = ("pca", "rp", "rp_achlioptas", "mds", "kpca", "kpca_nystrom",
           "isomap", "umap")


@pytest.fixture(scope="module")
def fitted(data):
    xtr, _ = data
    return {name: _fits(name, xtr) for name in METHODS}


@pytest.mark.parametrize("name", METHODS)
def test_transform_matches_jax(fitted, data, name):
    _, xte = data
    tred, jred = fitted[name]
    yt = tred(torch.from_numpy(xte)).numpy()
    yj = np.asarray(jred(jnp.asarray(xte)))
    assert yt.shape == yj.shape and np.isfinite(yt).all()
    linear = name in ("pca", "rp", "rp_achlioptas", "mds")
    _assert_embedding(yt, yj, LINEAR_RTOL if linear else NONLINEAR_RTOL)


@pytest.mark.parametrize("name", METHODS)
@pytest.mark.parametrize("k", [1, 6, 15])
def test_amk_accuracy_matches_jax(fitted, data, name, k):
    """A_m(k) does not depend on the embedding's signs. A neighbour flip at
    a near-tie in the reduced space moves it by 1/(40 k); the packages'
    embeddings differ by up to ~1e-4 of their scale (the eigh of the
    geodesic or kernel matrix), which flips up to 2 of Isomap's 600
    slots at k = 15 here: 3 flips are allowed."""
    xtr, xte = data
    tred, jred = fitted[name]
    at, aj = _amk_pair(tred, jred, xtr, xte, k)
    assert 0.0 <= at <= 1.0
    assert abs(at - aj) <= 3.0 / (40 * k) + 1e-9, (at, aj)


@pytest.mark.parametrize("name", ["pca", "rp", "rp_achlioptas", "mds"])
def test_affine_params_carry_across(fitted, data, name):
    """The linear baselines expose (matrix (m, D), mean (D,)); the bridge
    turns JAX's pair into a port Reducer with JAX's transform."""
    _, xte = data
    _, jred = fitted[name]
    mat, mean = (np.asarray(a) for a in jred.params)
    red = affine_reducer(jred.name, mat, mean, device="cpu")
    np.testing.assert_allclose(red(torch.from_numpy(xte)).numpy(),
                               np.asarray(jred(jnp.asarray(xte))),
                               rtol=1e-5, atol=1e-5)
    tred, _ = fitted[name]
    assert tred.params[0].shape == mat.shape
    assert tred.params[1].shape == mean.shape


def test_rp_achlioptas_is_sparse():
    red = tb.fit_random_projection(torch.Generator().manual_seed(2), 100, 10,
                                   kind="achlioptas")
    m = red(torch.eye(100))
    assert 0.5 < float((m == 0).float().mean()) < 0.8     # 2/3 expected


def test_median_is_jax_median():
    """An even count averages the two middle values (torch.median would
    return the lower one); this sets kPCA's gamma."""
    for n in (7, 8, 12720):
        v = np.random.default_rng(n).normal(size=n).astype(np.float32)
        assert float(tb._median(torch.from_numpy(v))) == float(
            jnp.median(jnp.asarray(v)))


def test_minplus_geodesics_match_jax():
    """The chunked min-plus squaring is the JAX broadcast, exactly."""
    rng = np.random.default_rng(5)
    g = rng.uniform(0.1, 5.0, (50, 50)).astype(np.float32)
    g[rng.uniform(size=g.shape) < 0.7] = 1e9
    np.fill_diagonal(g, 0.0)
    gj = np.asarray(jb._minplus_geodesics(jnp.asarray(g), 6))
    chunk = tb._CHUNK_ELEMS
    try:
        tb._CHUNK_ELEMS = 50 * 50 * 7              # ragged row chunks
        gt = tb._minplus_geodesics(torch.from_numpy(g), 6).numpy()
    finally:
        tb._CHUNK_ELEMS = chunk
    np.testing.assert_array_equal(gt, gj)


def test_fitters_registry_matches_jax(data):
    assert set(tb.BASELINE_FITTERS) == set(jb.BASELINE_FITTERS)
    xtr, xte = data
    gen = torch.Generator().manual_seed(0)
    for name, fit in tb.BASELINE_FITTERS.items():
        if name == "umap":
            continue                     # 150 epochs: covered above at 6
        red = fit(torch.from_numpy(xtr), 3, gen)
        y = red(torch.from_numpy(xte))
        assert y.shape == (40, 3) and bool(torch.isfinite(y).all()), name
