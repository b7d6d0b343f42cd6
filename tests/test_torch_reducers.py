"""Port parity for the pca and mlp reducers (repro_torch.search.reducers)
against repro.search.reducers, with JAX's draws fed into the mlp fit;
engines of both kinds carried across from JAX by repro_torch.bridge
return the JAX ids; the paper's configuration and the synthetic datasets
of the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import mpad_paper as jpaper  # noqa: E402
from repro.search import build_engine as jax_build_engine  # noqa: E402
from repro.search import reducers as jred  # noqa: E402
from repro_torch.bridge import state_from_arrays  # noqa: E402
from repro_torch.configs import mpad_paper as tpaper  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.search import (SearchEngine, build_engine,  # noqa: E402
                                config_from_spec)
from repro_torch.search import reducers as tred  # noqa: E402

N, D, K = 1200, 32, 10


def _clustered(seed, n, d=D, n_clusters=16):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 2.0
    lab = rng.integers(0, n_clusters, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    x = _clustered(0, N + 64)
    return x[:N], x[N:]


def _arrays(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _mlp_draws(key, x, m):
    """The JAX mlp fit's draws, as ``_mlp_fit`` makes them from ``key``:
    the linear init's start directions, the anchors, the negatives and
    the unscaled w1."""
    n, d = x.shape
    k_lin, k_anchor, k_neg, k_w1 = jax.random.split(key, 4)
    w0 = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_lin, k),
                                                (d,), jnp.float32))
                   for k in range(m)])
    n_anchor = min(256, n)
    hidden = int(min(max(2 * m, 16), 128))
    return dict(
        w0=torch.from_numpy(w0),
        anchors=np.array(jax.random.choice(k_anchor, n, (n_anchor,),
                                           replace=False)),
        negatives=np.array(jax.random.randint(k_neg, (n_anchor, 4), 0, n)),
        w1_draw=np.array(jax.random.normal(k_w1, (d, hidden), jnp.float32)))


def test_registry_matches_jax():
    assert tred.REDUCER_KINDS == jred.REDUCER_KINDS == ("qpad", "pca", "mlp")
    with pytest.raises(ValueError, match="registered kinds"):
        tred.get_reducer_ops("umap")


def test_pca_reducer_matches_jax(data):
    """Deterministic: the same components up to their signs."""
    x, q = data
    pj = jred._pca_fit(None, jnp.asarray(x[:400]), 8, None)
    r = tred.fit_reducer("pca", torch.from_numpy(x[:400]), 8)
    assert r.kind == "pca" and tred.reducer_dim(r) == 8
    mt, mj = r.params[0].numpy(), np.asarray(pj[0])
    sign = np.sign((mt * mj).sum(axis=1, keepdims=True))
    np.testing.assert_allclose(mt * sign, mj, atol=1e-4)
    np.testing.assert_allclose(r.params[1].numpy(), np.asarray(pj[1]),
                               rtol=1e-5, atol=1e-6)
    yt = r(torch.from_numpy(q)).numpy()
    yj = np.asarray(jred.reduce_vectors(jred.Reducer("pca", pj),
                                        jnp.asarray(q)))
    np.testing.assert_allclose(yt * sign.T, yj, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def mlp_pair(data):
    x, _ = data
    xs = x[:500]
    key = jax.random.key(11)
    pj = jred._mlp_fit(key, jnp.asarray(xs), 6, None)
    pt = tred.fit_reducer("mlp", torch.from_numpy(xs), 6,
                          **_mlp_draws(key, xs, 6)).params
    return pj, pt


def _mlp_outputs(pj, pt, q):
    yj = np.asarray(jred._mlp_transform(pj, jnp.asarray(q)))
    yt = tred.reduce_vectors(tred.Reducer("mlp", pt),
                             torch.from_numpy(q)).numpy()
    return yt, yj


def test_mlp_fit_matches_jax_in_few_steps(data, monkeypatch):
    """From JAX's draws, 5 Adam steps: the map on held-out points within
    3e-3 of the output's scale. The linear init (an MPAD fit of 24 steps)
    already differs by ~1e-3: both packages' Adam steps normalize the
    gradient, so its f32 rounding (matmuls summed in other orders) moves
    the directions by that much."""
    x, q = data
    xs = x[:500]
    key = jax.random.key(11)
    monkeypatch.setattr(jred, "_MLP_STEPS", 5)
    monkeypatch.setattr(tred, "_MLP_STEPS", 5)
    pj = jred._mlp_fit(key, jnp.asarray(xs), 6, None)
    pt = tred.fit_reducer("mlp", torch.from_numpy(xs), 6,
                          **_mlp_draws(key, xs, 6)).params
    yt, yj = _mlp_outputs(pj, pt, q)
    assert np.abs(yt - yj).max() <= 3e-3 * np.abs(yj).max()


def test_mlp_fit_matches_jax(mlp_pair, data):
    """The full fit (150 Adam steps) from JAX's draws: the same choice to
    keep the residual and the same map on held-out points within 5% of
    its scale. Adam's normalized steps carry the ~1e-3 difference of the
    linear init through 150 steps of a triplet hinge (3.9% measured at
    these seeds)."""
    pj, pt = mlp_pair
    _, q = data
    assert set(pt) == set(pj) == {"mean", "lin", "w1", "b1", "w2"}
    kept_j = bool(np.abs(np.asarray(pj["w2"])).max() > 0)
    kept_t = bool(pt["w2"].abs().max() > 0)
    assert kept_t == kept_j
    yt, yj = _mlp_outputs(pj, pt, q)
    assert yt.shape == (64, 6)
    assert np.abs(yt - yj).max() <= 0.05 * np.abs(yj).max()
    assert tred.reducer_dim(tred.Reducer("mlp", pt)) == 6


def test_mlp_transform_matches_jax_on_jax_params(mlp_pair, data):
    pj, _ = mlp_pair
    _, q = data
    params = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    np.testing.assert_allclose(
        tred.Reducer("mlp", params)(torch.from_numpy(q)).numpy(),
        np.asarray(jred._mlp_transform(pj, jnp.asarray(q))),
        rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_engines(data):
    x, _ = data
    specs = ("pca8>rr16", "mlp8>ivf16x4>pq4x256:i8>rr32")
    return {s: jax_build_engine(x, s, fit_sample=600) for s in specs}


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("spec,backend", [
    ("pca8>rr16", "jnp"), ("mlp8>ivf16x4>pq4x256:i8>rr32", "jnp"),
    ("mlp8>ivf16x4>pq4x256:i8>rr32", "kernel")])
def test_carried_engine_returns_jax_ids(jax_engines, data, spec, backend,
                                        batch):
    """The JAX engine's state through the bridge: the port's SearchEngine
    returns the JAX ids (on the CPU, @kernel is the kernels' plain
    versions)."""
    _, q = data
    jeng = jax_engines[spec]
    state = state_from_arrays(_arrays(jeng.state), spec, device="cpu")
    assert state.proj.kind == spec[:3]
    teng = SearchEngine.from_state(state,
                                   config_from_spec(spec, pq_backend=backend))
    dt, it = teng.search(q[:batch], K)
    dj, ij = jeng.search(jnp.asarray(q[:batch]), K)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_own_pca_engine_returns_jax_ids(jax_engines, data):
    """PCA is deterministic and the flat scan exact: the port's own build
    of pca8>rr16 (from the same fit rows) returns the JAX engine's ids."""
    x, q = data
    jeng = jax_engines["pca8>rr16"]
    rows = np.asarray(jax.random.choice(jax.random.key(0), N, (600,),
                                        replace=False))
    from repro_torch.search.registry import BuildInits
    teng = build_engine(x, "pca8>rr16", device="cpu", fit_sample=600,
                        inits=BuildInits(fit_rows=torch.from_numpy(
                            np.array(rows))))
    _, it = teng.search(q, K)
    _, ij = jeng.search(jnp.asarray(q), K)
    assert (it.numpy() == np.asarray(ij)).mean() >= 0.99


def test_own_mlp_engine_builds_and_searches(data):
    x, q = data
    eng = build_engine(x, "mlp8>ivf8x4>pq4x64>rr32", device="cpu",
                       fit_sample=400, seed=3)
    assert eng.state.proj.kind == "mlp"
    assert tred.reducer_dim(eng.state.proj) == 8
    d, i = eng.search(q[:16], K)
    assert d.shape == (16, K) and bool(torch.isfinite(d).all())
    assert "fit" in eng.build_seconds


def test_paper_config_matches_jax():
    for name in ("TARGET_RATIOS", "K_VALUES", "ALPHA_GRID", "B_GRID",
                 "FIXED_PARAMS", "SAMPLING"):
        assert getattr(tpaper, name) == getattr(jpaper, name), name
    for ds in tpaper.FIXED_PARAMS:
        cj, ct = jpaper.mpad_config(ds, 12), tpaper.mpad_config(ds, 12)
        assert (ct.m, ct.alpha, ct.b, ct.iters, ct.backend) == (
            cj.m, cj.alpha, cj.b, cj.iters, cj.backend)


@pytest.mark.parametrize("name", sorted(synthetic.PAPER_DATASETS))
def test_paper_datasets_have_the_jax_shapes(name):
    """The JAX stand-ins' defaults and shapes, seeded, float32; the spike
    columns carry the largest variance."""
    import inspect

    from repro.data import synthetic as jsyn
    fn, dim, test = synthetic.PAPER_DATASETS[name]
    jfn, jdim, jtest = jsyn.PAPER_DATASETS[name]
    assert (fn.__name__, dim, test) == (jfn.__name__, jdim, jtest)
    params = inspect.signature(fn).parameters
    jparams = inspect.signature(jfn).parameters
    defaults = {k: p.default for k, p in params.items() if k != "gen"}
    assert defaults == {k: p.default for k, p in jparams.items()
                        if k != "key"}
    gen = lambda: torch.Generator().manual_seed(5)      # noqa: E731
    a_tr, a_te = fn(gen(), n_train=64, n_test=16)
    b_tr, _ = fn(gen(), n_train=64, n_test=16)
    assert torch.equal(a_tr, b_tr) and bool(torch.isfinite(a_tr).all())
    assert a_tr.dtype == torch.float32
    assert a_tr.shape == (64, defaults["dim"]) and a_te.shape[0] == 16


def test_clustered_and_spikes():
    gen = torch.Generator().manual_seed(0)
    tr, te = synthetic.make_clustered(gen, 100, 10, 8)
    assert tr.shape == (100, 8) and te.shape == (10, 8)
    x = synthetic.make_informative_plus_spikes(
        torch.Generator().manual_seed(1), 4000, 10, 50, spike_prob=0.03)
    spikes = x[:, 10:].abs() > 1.0
    assert 0.02 < float(spikes.float().mean()) < 0.04
    nn = synthetic.make_informative_plus_spikes(
        torch.Generator().manual_seed(1), 50, 4, 6, nonneg=True)
    assert bool((nn >= 0).all())
