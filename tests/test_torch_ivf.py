"""Port parity for the ivf kind (repro_torch.search.ivf and the registry's
ivf entry): engine states built by the JAX package, carried across by
repro_torch.bridge, serve JAX search_fn's ids through the port's
SearchEngine at batches 1, 8, 64 and 256, with and without a Reduce
stage; build_ivf from JAX's k-means starting rows gives JAX's posting
lists; the port's own engine builds and serves the kind."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.bridge import state_from_arrays  # noqa: E402
from repro_torch.search import (SearchEngine, build_engine,  # noqa: E402
                                config_from_spec, knn_scan)
from repro_torch.search import ivf as tivf  # noqa: E402

N, D, K = 3000, 64, 10
BATCHES = (1, 8, 64, 256)
SPECS = ("ivf64x8", "qpad16>ivf64x8")


def _jax():
    """JAX is imported lazily: the machine with the card has none."""
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _clustered(seed, n, d=D, n_clusters=24):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 2.0
    lab = rng.integers(0, n_clusters, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


def _arrays(state):
    jax, _ = _jax()
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.fixture(scope="module")
def engines():
    """The two ivf engines built by the JAX package, their states carried
    across, and JAX's jitted search_fn."""
    jax, _ = _jax()
    from repro.core import MPADConfig as JConfig
    from repro.search import build_engine as jax_build_engine
    from repro.search.serve import _SEARCH_STATICS, search_fn
    x = _clustered(0, N)
    q = _clustered(0, N + 256)[N:]                 # held out, same clusters
    jstates, tstates = {}, {}
    for spec in SPECS:
        kw = {"mpad": JConfig(m=16, iters=8)} if "qpad" in spec else {}
        js = jax_build_engine(x, spec, fit_sample=1024, **kw).state
        jstates[spec] = js
        tstates[spec] = state_from_arrays(_arrays(js), spec, device="cpu")
    return x, q, jstates, tstates, jax.jit(search_fn,
                                           static_argnames=_SEARCH_STATICS)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("spec", SPECS)
def test_bridged_ivf_engine_returns_jax_ids(engines, spec, batch):
    _, jnp = _jax()
    _, q, jstates, tstates, jsearch = engines
    cfg = config_from_spec(spec)
    dj, ij = jsearch(jstates[spec], jnp.asarray(q[:batch]), K,
                     nprobe=cfg.nprobe, rerank=cfg.rerank)
    teng = SearchEngine.from_state(tstates[spec], cfg)
    dt, it = teng.search(q[:batch], K)
    assert teng.last_bucket == batch
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # the scan's and the re-rank's feature sums run in another order than
    # XLA's
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_bridge_carries_the_ivf_payload(engines):
    _, _, jstates, tstates, _ = engines
    for spec in SPECS:
        jix, tix = jstates[spec].index.payload, tstates[spec].index.payload
        assert isinstance(tix, tivf.IVFIndex)
        for f in tivf.IVFIndex._fields:
            np.testing.assert_array_equal(getattr(tix, f).numpy(),
                                          np.asarray(getattr(jix, f)))
        assert tix.lists.dtype == torch.int64


def test_build_ivf_from_jax_inits_gives_jax_lists():
    """build_ivf from the k-means starting rows JAX's build draws: the same
    posting lists, centroids up to the cluster sums' order."""
    jax, jnp = _jax()
    from repro.search import ivf as jivf
    x = _clustered(1, 2000, d=16)
    key = jax.random.key(3)
    jix = jivf.build_ivf(key, jnp.asarray(x), 32)
    init = np.asarray(jax.random.choice(key, 2000, (32,), replace=False))
    tix = tivf.build_ivf(torch.from_numpy(x), 32,
                         init=torch.from_numpy(np.array(init)).long())
    np.testing.assert_array_equal(tix.lists.numpy(), np.asarray(jix.lists))
    np.testing.assert_allclose(tix.centroids.numpy(),
                               np.asarray(jix.centroids), rtol=1e-4,
                               atol=1e-5)
    cv = tivf.cell_vectors(tix.lists, tix.vectors)
    np.testing.assert_array_equal(
        cv.numpy(), np.asarray(jivf.cell_vectors(jix.lists,
                                                 jnp.asarray(x))))


def test_ivf_scan_matches_jax_on_the_same_index(engines):
    """ivf_scan alone on the bridged index: JAX ivf_scan's ids, k above
    the probed rows padded with (inf, -1)."""
    _, jnp = _jax()
    from repro.search import ivf as jivf
    _, q, jstates, tstates, _ = engines
    jix, tix = (jstates["ivf64x8"].index.payload,
                tstates["ivf64x8"].index.payload)
    for nprobe, k in ((8, 10), (1, 500)):
        dj, ij = jivf.ivf_scan(jix, jnp.asarray(q[:16]), k, nprobe)
        dt, it = tivf.ivf_scan(tix, torch.from_numpy(q[:16]), k, nprobe)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


@pytest.mark.parametrize("spec", ["ivf16x4", "qpad8>ivf16x4>rr32"])
def test_port_built_ivf_engine_serves(spec):
    """The port's own build: every row lands in one posting list, and a
    full probe returns exact search's ids."""
    from repro_torch.core.mpad import MPADConfig
    x = _clustered(2, 800, d=32)
    kw = {"mpad": MPADConfig(m=8, iters=4)} if "qpad" in spec else {}
    eng = build_engine(x, spec, device="cpu", fit_sample=512, **kw)
    lists = eng.state.index.payload.lists
    ids = lists[lists >= 0]
    assert torch.equal(ids.sort().values, torch.arange(800))
    _, it = eng.search(x[:32], K)
    assert (it[:, 0] == torch.arange(32)).all()
    if "qpad" not in spec:
        import dataclasses
        full = SearchEngine.from_state(
            eng.state, dataclasses.replace(eng.config, nprobe=16))
        _, truth = knn_scan(torch.from_numpy(x[:32]), torch.from_numpy(x),
                            K)
        assert torch.equal(full.search(x[:32], K)[1], truth)
