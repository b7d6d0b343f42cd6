"""Reducer and index zoo conformance on the port (twin of
tests/test_zoo.py, without its sharded case, which waits for ROADMAP.md
item 11): every registered reducer kind (qpad | pca | mlp) against every
index layout (flat | ivf | pq | opq | ivfpq).

* grammar: every combination parses, ``format_spec`` round-trips and
  formats as JAX's does; unknown kinds and malformed tokens raise the
  JAX package's errors;
* build and search: the engine returns the ids of an oracle re-encoded
  from scratch under the same frozen quantizers (``rebuild_state``);
* snapshots: save / load round-trips to identical ids, including a
  snapshot without the ``"reducer"`` key (loaded as qpad);
* streaming: interleaved upserts and deletes, then ``compact()``, equal
  a from-scratch rebuild over the survivors.

The port runs on the CPU (``device="cpu"``), its kernels' plain versions;
one build per combination, shared by the tests.
"""
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.core.mpad import MPADConfig  # noqa: E402
from repro_torch.search import (REDUCER_KINDS, StreamConfig,  # noqa: E402
                                build_engine, format_spec, load_engine,
                                make_mutable, parse_spec, rebuild_state,
                                save_engine, search_fn)

N, DIM, M, K = 600, 32, 8, 10

# index layouts as spec fragments (opq composes with a reducer but not with
# a coarse stage: the rotation is global)
_INDEX_FRAGS = {
    "flat": "flat",
    "ivf": "ivf12x5",
    "pq": "pq8x64",
    "opq": "opq8x64",
    "ivfpq": "ivf12x5>pq8x64",
}
_COMBOS = [(red, idx) for red in REDUCER_KINDS for idx in _INDEX_FRAGS]
# a short qpad fit keeps 15 builds inside the file's time budget
_RUNTIME = dict(fit_sample=512, seed=0,
                mpad=MPADConfig(m=M, b=80.0, alpha=25.0, iters=8))


def _spec(red, index):
    return f"{red}{M}>{_INDEX_FRAGS[index]}"


def _data(seed=0, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2
    lab = rng.integers(0, 12, n)
    return (centers[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _queries(nq=16, d=DIM):
    rng = np.random.default_rng(9)
    return torch.from_numpy(
        (_data(d=d)[:nq] + 0.02 * rng.normal(size=(nq, d))).astype(
            np.float32))


def _runtime(red):
    return _RUNTIME if red == "qpad" else {k: v for k, v in _RUNTIME.items()
                                           if k != "mpad"}


_ENGINES = {}


def _engine(red, index):
    """One build per combo (the reducer fit and index training are the
    slow part)."""
    if (red, index) not in _ENGINES:
        _ENGINES[(red, index)] = build_engine(
            _data(), _spec(red, index), device="cpu", **_runtime(red))
    return _ENGINES[(red, index)]


# --- grammar ---------------------------------------------------------------

@pytest.mark.parametrize("red,index", _COMBOS)
def test_spec_round_trips(red, index):
    from repro.search import format_spec as jax_format_spec
    from repro.search import parse_spec as jax_parse_spec
    spec = parse_spec(_spec(red, index))
    assert spec.reduce.kind == red and spec.reduce.m == M
    assert spec.kind == index
    assert parse_spec(format_spec(spec)) == spec
    assert format_spec(spec) == jax_format_spec(jax_parse_spec(_spec(red,
                                                                     index)))


@pytest.mark.parametrize("bad,match", [
    ("zap16>flat", "registered reducer kinds"),
    ("flat>flat", "duplicate 'flat'"),
    ("ivf12x5>flat", "mixes 'flat'"),
    ("flat>pq8x64", "mixes 'flat'"),
    ("rr40>flat", "out of pipeline order"),
    ("qpad8>ivf12x5>opq8x64", "opq"),
])
def test_malformed_specs_raise_jax_errors(bad, match):
    from repro.search import parse_spec as jax_parse_spec
    with pytest.raises(ValueError, match=match) as te:
        parse_spec(bad)
    with pytest.raises(ValueError) as je:
        jax_parse_spec(bad)
    assert str(te.value) == str(je.value)
    if bad.startswith("zap"):
        for kind in REDUCER_KINDS:
            assert kind in str(te.value)


# --- build, search, snapshot ---------------------------------------------

@pytest.mark.parametrize("red,index", _COMBOS)
def test_search_matches_rebuild_oracle_and_snapshot(red, index):
    """The engine's ids equal an oracle re-encoded from scratch under the
    same frozen quantizers, and a save / load round trip (with and
    without the snapshot's ``"reducer"`` key, the latter for qpad, as a
    pre-zoo snapshot) returns them again."""
    eng = _engine(red, index)
    _, frozen = make_mutable(eng.state, StreamConfig(delta_capacity=64))
    oracle = rebuild_state(frozen, torch.from_numpy(_data()))
    q = _queries()
    d1, i1 = eng.search(q, K)
    d2, i2 = search_fn(oracle, q, K, nprobe=5, rerank=64, backend="jnp")
    assert torch.equal(i1, i2)
    torch.testing.assert_close(d1, d2, atol=1e-5, rtol=0)
    with tempfile.TemporaryDirectory() as td:
        save_engine(eng, td)
        meta_path = os.path.join(td, "engine.json")
        with open(meta_path) as f:
            meta = json.load(f)
        assert meta["reducer"] == red
        eng2 = load_engine(td, device="cpu")
        if red == "qpad":
            del meta["reducer"]              # what old snapshots look like
            with open(meta_path, "w") as f:
                json.dump(meta, f)
            eng3 = load_engine(td, device="cpu")
            assert eng3.reducer.kind == "qpad"
            assert torch.equal(eng3.search(q, K)[1], i1)
    assert eng2.reducer.kind == red
    d3, i3 = eng2.search(q, K)
    assert torch.equal(i1, i3)
    torch.testing.assert_close(d1, d3, atol=1e-6, rtol=0)


# --- streaming: interleaved writes + compact == rebuild -------------------

@pytest.mark.parametrize("red,index", _COMBOS)
def test_stream_compact_equals_rebuild(red, index):
    eng = build_engine(_data(), _spec(red, index), device="cpu",
                       stream=StreamConfig(delta_capacity=64),
                       **_runtime(red))
    rng = np.random.RandomState(3)
    base = _data()
    alive = {i: base[i] for i in range(N)}
    next_id = N
    for _ in range(6):
        if rng.rand() < 0.6:
            ids = np.arange(next_id, next_id + 8)
            vecs = rng.randn(8, DIM).astype(np.float32)
            next_id += 8
            for i, v in zip(ids, vecs):
                alive[int(i)] = v
            eng.upsert(ids, vecs)
        else:
            drop = [int(i) for i in rng.choice(list(alive), 5, replace=False)]
            for i in drop:
                del alive[i]
            eng.delete(np.array(drop))
    eng.compact()
    assert int(eng.store.delta_count) == 0
    surv_ids = np.array(sorted(alive))
    surv = torch.from_numpy(np.stack([alive[i] for i in surv_ids]))
    oracle = rebuild_state(eng.frozen, surv)
    q = _queries()
    d_r, i_r = search_fn(oracle, q, K, nprobe=5, rerank=64, backend="jnp")
    ext_r = surv_ids[i_r.numpy()]
    d_s, i_s = eng.search(q, K)
    np.testing.assert_array_equal(np.sort(i_s.numpy(), axis=1),
                                  np.sort(ext_r, axis=1))
    np.testing.assert_allclose(np.sort(d_s.numpy(), axis=1),
                               np.sort(d_r.numpy(), axis=1), atol=1e-4)


# --- the acceptance specs, verbatim ----------------------------------------

@pytest.mark.parametrize("spec", ["pca32>ivf64x8>pq8x256:i8", "mlp32>flat",
                                  "qpad32>opq8x256:i8"])
def test_acceptance_specs_end_to_end(spec):
    """The named specs parse, build, search, and snapshot round-trip with
    pinned ids (a 64-dim corpus so m = 32 reduces)."""
    corpus = _data(n=800, d=64)
    kw = dict(fit_sample=512, seed=0)
    if spec.startswith("qpad"):
        kw["mpad"] = MPADConfig(m=32, b=80.0, alpha=25.0, iters=8)
    eng = build_engine(corpus, spec, device="cpu", **kw)
    q = _queries(d=64)
    _, i1 = eng.search(q, K)
    assert i1.shape == (q.shape[0], K)
    with tempfile.TemporaryDirectory() as td:
        save_engine(eng, td)
        eng2 = load_engine(td, device="cpu")
    _, i2 = eng2.search(q, K)
    assert torch.equal(i1, i2)
