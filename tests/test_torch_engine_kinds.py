"""Port parity for the pq, opq and flat kinds: engine states built by the
JAX package, carried across by repro_torch.bridge, serve the JAX ids
through the port's SearchEngine at batches 1, 8, 64 and 256, on both ADC
backends and every LUT type; the default SearchEngine builds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import MPADConfig as JConfig  # noqa: E402
from repro.search import SearchEngine as JSearchEngine  # noqa: E402
from repro.search import build_engine as jax_build_engine  # noqa: E402
from repro.search import registry as jreg  # noqa: E402
from repro.search.reducers import reduce_vectors  # noqa: E402
from repro.search.serve import (_SEARCH_STATICS,  # noqa: E402
                                EngineState, search_fn)
from repro.search.spec import parse_spec as jax_parse_spec  # noqa: E402
from repro_torch.bridge import state_from_arrays  # noqa: E402
from repro_torch.search import (SearchEngine, config_from_spec,  # noqa: E402
                                knn_scan)

N, D, K = 3000, 64, 10
BATCHES = (1, 8, 64, 256)
CODED = {"pq": "qpad16>pq8x256>rr32", "opq": "qpad16>opq8x256>rr32"}
FLAT = ("flat", "qpad16>flat>rr32")

_jax_search = jax.jit(search_fn, static_argnames=_SEARCH_STATICS)


def _clustered(seed, n, d=D, n_clusters=24):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 2.0
    lab = rng.integers(0, n_clusters, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


def _arrays(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.fixture(scope="module")
def engines():
    """One QPAD fit (the JAX pq engine's); the opq index and the reduced
    flat index are built over the same reduced corpus, as their own
    engines would build them from the same reducer."""
    x = _clustered(0, N)
    q = _clustered(0, N + 256)[N:]                 # held out, same clusters
    jeng = jax_build_engine(x, CODED["pq"], mpad=JConfig(m=16, iters=8),
                            fit_sample=1024)
    js = jeng.state
    reduced = reduce_vectors(js.proj, js.corpus)
    opq = jreg.get_ops("opq").build(jax.random.key(0), reduced,
                                    jax_parse_spec(CODED["opq"]))
    jstates = {
        CODED["pq"]: js,
        CODED["opq"]: js._replace(index=jreg.Index("opq", opq)),
        "flat": EngineState(corpus=js.corpus, proj=None,
                            index=jreg.Index("flat", js.corpus)),
        "qpad16>flat>rr32": js._replace(index=jreg.Index("flat", reduced)),
    }
    tstates = {spec: state_from_arrays(_arrays(s), spec, device="cpu")
               for spec, s in jstates.items()}
    return x, q, jstates, tstates


def _check(engines, spec, batch, **runtime):
    _, q, jstates, tstates = engines
    lut = runtime.get("lut_dtype", "f32")
    dj, ij = _jax_search(jstates[spec], jnp.asarray(q[:batch]), K,
                         rerank=32, lut_dtype=lut)
    teng = SearchEngine.from_state(tstates[spec],
                                   config_from_spec(spec, **runtime))
    dt, it = teng.search(q[:batch], K)
    assert teng.last_bucket == batch               # no padding at these sizes
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # the final distances come from the exact f32 re-rank, whose feature
    # sum runs in another order than XLA's
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


@pytest.mark.parametrize("backend", ["jnp", "kernel"])
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("kind", sorted(CODED))
def test_coded_engine_returns_jax_ids(engines, kind, batch, lut_dtype,
                                      backend):
    _check(engines, CODED[kind], batch, lut_dtype=lut_dtype,
           pq_backend=backend)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("spec", FLAT)
def test_flat_engine_returns_jax_ids(engines, spec, batch):
    _check(engines, spec, batch)


def test_default_engine_builds_and_is_exact(engines):
    """ServeConfig's default kind is flat with no reducer: an exact search,
    the JAX default engine's ids."""
    x, q, _, _ = engines
    teng = SearchEngine(x, device="cpu")
    assert teng.state.index.kind == "flat" and teng.state.proj is None
    dt, it = teng.search(q[:64], K)
    _, truth = knn_scan(torch.from_numpy(q[:64]), torch.from_numpy(x), K)
    assert torch.equal(it, truth)
    _, ij = JSearchEngine(x).search(q[:64], K)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
