"""Port parity for the certified re-rank pre-filter
(repro_torch.search.serve.prefiltered_rerank): on ivfpq states built by
the JAX package and carried across, search_fn(..., prefilter=r_s) returns
JAX search_fn's ids with the same prefilter, and the full re-rank's ids,
at f32, bf16 and int8; the port of the property of
tests/test_scan_path.py (no true top-k id is ever dropped); the engine's
prefilter_batch knob and its guard rails."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.bridge import state_from_arrays  # noqa: E402
from repro_torch.search import (SearchEngine, ServeConfig,  # noqa: E402
                                StreamConfig, config_from_spec,
                                stream_search_fn)
from repro_torch.search.serve import search_fn  # noqa

N, DIM, K = 601, 32, 10
LUTS = ("f32", "bf16", "int8")
# pq8x64 is test_scan_path.py's index; pq32x256's reconstruction error is
# small enough that the tight branch runs at f32
SPECS = ("ivf16x8>pq8x64>rr64", "ivf16x8>pq32x256>rr64")


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _data_np():
    """test_scan_path.py's outlier-skewed corpus (~40% of rows in one
    cluster), drawn by JAX and carried as numpy."""
    jax, jnp = _jax()
    key = jax.random.key(0)
    centers = jax.random.normal(key, (12, DIM)) * 2
    lab = jax.random.randint(jax.random.fold_in(key, 1), (N,), 0, 12)
    heavy = jax.random.uniform(jax.random.fold_in(key, 3), (N,)) < 0.4
    lab = jnp.where(heavy, 0, lab)
    return np.asarray(centers[lab] + 0.3 * jax.random.normal(
        jax.random.fold_in(key, 2), (N, DIM)))


def _queries(seed, nq=8):
    jax, _ = _jax()
    return (_data_np()[:nq] + 0.1 * np.asarray(
        jax.random.normal(jax.random.key(seed), (nq, DIM)))).astype(
            np.float32)


@pytest.fixture(scope="module")
def states():
    jax, _ = _jax()
    from repro.search import build_engine as jax_build_engine
    out = {}
    for spec in SPECS:
        js = jax_build_engine(_data_np(), spec).state
        flat, _ = jax.tree_util.tree_flatten_with_path(js)
        arrays = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
        out[spec] = (js, state_from_arrays(arrays, spec, device="cpu"))
    return out


def _search(state, q, k, lut, prefilter, counters=None):
    return search_fn(state, torch.from_numpy(q), k, nprobe=8, rerank=64,
                     lut_dtype=lut, prefilter=prefilter, counters=counters)


@pytest.mark.parametrize("lut", LUTS)
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("k", [1, 10])
def test_prefilter_returns_jax_ids(states, spec, lut, k):
    _, jnp = _jax()
    from repro.search.serve import search_fn as jax_search_fn
    js, ts = states[spec]
    q = _queries(11)
    r_s = max(2 * k, 32)
    dj, ij = jax_search_fn(js, jnp.asarray(q), k, nprobe=8, rerank=64,
                           lut_dtype=lut, prefilter=r_s)
    dt, it = _search(ts, q, k, lut, r_s)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    _, i0 = _search(ts, q, k, lut, 0)
    assert torch.equal(it, i0)


def test_tight_branch_runs_at_f32(states):
    """At f32 on the low-error index every query's survivors fit: the
    narrow re-rank runs; its ids are the full re-rank's."""
    _, ts = states[SPECS[1]]
    counts = {}
    q = _queries(5)
    _, it = _search(ts, q, K, "f32", 32, counts)
    assert counts == {"prefilter_tight": 1}
    assert torch.equal(it, _search(ts, q, K, "f32", 0)[1])


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10 ** 6), st.integers(1, 10),
       st.sampled_from(["f32", "bf16", "int8"]))
def test_prefilter_never_drops_a_true_topk_id(seed, k, lut):
    """Property: for any queries, k and LUT width, the pre-filtered
    re-rank returns the ids and distances of the full-width re-rank."""
    _, ts = _states_once()
    q = _queries(seed)
    r_s = max(2 * k, 32)
    dp, ip = _search(ts, q, k, lut, r_s)
    d0, i0 = _search(ts, q, k, lut, 0)
    assert torch.equal(ip, i0)
    np.testing.assert_allclose(dp.numpy(), d0.numpy(), rtol=1e-6)


_STATE = {}


def _states_once():
    """The pq8x64 pair for the property (a hypothesis test takes no
    fixture in this suite's stub)."""
    if not _STATE:
        jax, _ = _jax()
        from repro.search import build_engine as jax_build_engine
        js = jax_build_engine(_data_np(), SPECS[0]).state
        flat, _ = jax.tree_util.tree_flatten_with_path(js)
        arrays = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
        _STATE["pair"] = (js, state_from_arrays(arrays, SPECS[0],
                                                device="cpu"))
    return _STATE["pair"]


@pytest.mark.parametrize("nq", [1, 3, 8, 24, 64])
def test_engine_prefilter_batch_keeps_ids(states, nq):
    """The engine engages the pre-filter on buckets <= prefilter_batch
    (r_s = max(2k, rerank // 2)) with the ids of prefilter_batch=0."""
    _, ts = states[SPECS[1]]
    q = np.concatenate([_queries(100 + nq, 8)] * 8)[:nq]
    fast = SearchEngine.from_state(ts, config_from_spec(
        SPECS[1], prefilter_batch=64))
    slow = SearchEngine.from_state(ts, config_from_spec(SPECS[1]))
    _, i1 = fast.search(q, K)
    assert fast.counters["prefilter_tight"] + \
        fast.counters["prefilter_full"] == 1
    _, i2 = slow.search(q, K)
    assert slow.counters["prefilter_tight"] + \
        slow.counters["prefilter_full"] == 0
    assert torch.equal(i1, i2)


def test_prefilter_requires_scan_space_eq_rerank_space(states):
    """With a Reduce stage the bounds certify nothing about the re-rank
    space: search_fn refuses; the engine leaves the pre-filter off."""
    from repro_torch.core.mpad import MPADConfig
    from repro_torch.search import build_engine
    x = _data_np()
    eng = build_engine(x, "qpad8>ivf16x8>pq8x64>rr64", device="cpu",
                       fit_sample=512, mpad=MPADConfig(m=8, iters=4),
                       prefilter_batch=64)
    q = torch.from_numpy(_queries(1))
    with pytest.raises(ValueError, match="prefilter"):
        search_fn(eng.state, q, K, nprobe=8, rerank=64, prefilter=32)
    eng.search(q, K)
    assert eng.counters["prefilter_tight"] + \
        eng.counters["prefilter_full"] == 0
    with pytest.raises(ValueError, match="prefilter_batch"):
        ServeConfig(index="ivfpq", prefilter_batch=-1)


def test_stream_rejects_fast_paths(states):
    _, ts = states[SPECS[0]]
    eng = SearchEngine.from_state(ts, config_from_spec(
        SPECS[0], stream=StreamConfig(delta_capacity=64)))
    q = torch.from_numpy(_queries(2))
    for kw in ({"scan_cap": 128}, {"prefilter": 32}):
        with pytest.raises(ValueError, match="scan_cap/prefilter"):
            stream_search_fn(eng.store, eng.frozen, q, K, **kw)
    # a streaming engine never engages either, whatever its knobs
    eng.config = dataclasses.replace(eng.config, prefilter_batch=64)
    assert eng.search(q, K)[1].shape == (8, K)
