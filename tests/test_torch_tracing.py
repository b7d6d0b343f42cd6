"""Port parity for request-level tracing (repro_torch.search.tracing):
twins of tests/test_tracing.py, and the instruments held against the JAX
package's.

* the deep trace: JAX's stage names (project/probe/scan/rerank for ivfpq,
  project/scan/rerank otherwise), ordered, non-negative, summing to
  within 10% of the staged run's own end-to-end time; the streaming
  engine refused;
* zero interference: traced searches return the untraced engine's ids
  and distances bit for bit, and ``compile_count`` moves as it would
  untraced;
* histograms, the slow-query ring, Chrome-trace export, the recall EMA
  feeding ``MaintenancePolicy.observe_recall``, the ``trace_dir``
  property, ``torch_profile``;
* ``shadow_recall`` equal to JAX's on a bridged read-only engine and on a
  bridged streaming engine after deletes (tombstone-aware).

The port runs on the CPU (``device="cpu"``), its kernels' plain versions.
JAX is imported inside the tests (this file holds ``gpu`` tests, run on
the card where JAX is absent).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.bridge import (state_from_arrays,  # noqa: E402
                                stream_from_arrays)
from repro_torch.search import (PolicyConfig, SearchEngine,  # noqa: E402
                                ServeConfig, StreamConfig, TraceConfig,
                                build_engine, config_from_spec, deep_trace,
                                torch_profile)
from repro_torch.search.tracing import (LatencyHistogram,  # noqa: E402
                                        shadow_recall)

N, DIM, K = 600, 32, 10


def _data(seed=0, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2
    lab = rng.integers(0, 12, n)
    return (centers[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _queries(n=8, seed=3):
    return torch.from_numpy(_data(seed=seed, n=n))


def _kw(eng):
    """The normalized knob dict ``search`` dispatches with."""
    cfg = eng.config
    probed = cfg.index in ("ivf", "ivfpq")
    coded = cfg.index in ("pq", "opq", "ivfpq")
    return dict(nprobe=cfg.nprobe if probed else 0, rerank=cfg.rerank,
                backend=cfg.pq_backend if coded else "jnp",
                lut_dtype=cfg.lut_dtype if coded else "f32",
                scan_cap=0, prefilter=0)


def _build(spec, **kw):
    return build_engine(_data(), spec, device="cpu", **kw)


def _within_10pct(out):
    total = sum(ms for _, ms in out["stages"])
    assert out["e2e_ms"] > 0.0
    assert abs(total - out["e2e_ms"]) <= 0.10 * out["e2e_ms"]


# --- twins of tests/test_tracing.py ------------------------------------------

def test_deep_trace_ivfpq_decomposition():
    """Four named non-overlapping stages whose sum is within 10% of the
    staged run's measured end-to-end time."""
    eng = _build("ivf12x4>pq8x64>rr40")
    q = _queries()
    eng.search(q, K)
    out = deep_trace(eng, q, K, _kw(eng))
    assert out is not None
    assert [s for s, _ in out["stages"]] == ["project", "probe", "scan",
                                             "rerank"]
    assert all(ms >= 0.0 for _, ms in out["stages"])
    _within_10pct(out)


def test_deep_trace_generic_kind_and_guards():
    """Non-ivfpq kinds decompose as project/scan/rerank; a streaming
    engine refuses instead of lying."""
    eng = _build("ivf12x4")
    out = deep_trace(eng, _queries(), K, _kw(eng))
    assert [s for s, _ in out["stages"]] == ["project", "scan", "rerank"]
    _within_10pct(out)
    streaming = SearchEngine(_data(), ServeConfig(
        index="flat", stream=StreamConfig(delta_capacity=64)), device="cpu")
    assert deep_trace(streaming, _queries(), K, _kw(streaming)) is None


def test_tracing_changes_no_results_or_compiles():
    """Traced searches return bit-identical results, and the sampled
    deep traces and shadow checks never move compile_count."""
    plain = _build("ivf12x4>pq8x64>rr40")
    traced = _build("ivf12x4>pq8x64>rr40").tracing(
        deep_trace_every=1, recall_every=1, slow_query_ms=0.0)
    q = _queries()
    d0, i0 = plain.search(q, K)
    compiles = traced.compile_count
    for _ in range(3):
        d1, i1 = traced.search(q, K)
    assert traced.compile_count == compiles + 1    # the one program
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    assert traced.tracer.deep_traces == 3


def test_histogram_record_and_percentiles():
    h = LatencyHistogram()
    assert h.snapshot().percentile(50) == 0.0      # empty -> 0
    for _ in range(100):
        h.record(0.04)                             # below the first bound
    snap = h.snapshot()
    assert snap.count == 100
    assert snap.sum_ms == pytest.approx(4.0)
    assert 0.0 <= snap.percentile(50) <= 0.05
    h2 = LatencyHistogram()
    h2.record(1e9)                                 # beyond every bound
    over = h2.snapshot()
    assert over.counts[-1] == 1
    assert over.bounds_ms[-1] < over.percentile(50) <= over.bounds_ms[-1] * 2
    h3 = LatencyHistogram()
    for _ in range(10):
        h3.record(1.0)
    s3 = h3.snapshot()
    assert s3.percentile(25) < s3.percentile(75)
    # JAX's 22 bounds, and JAX's bucket for every recorded value
    from repro.search.tracing import LatencyHistogram as JHistogram
    hj, ht = JHistogram(), LatencyHistogram()
    for ms in (0.0, 0.05, 0.0500001, 0.1, 1.0, 3.3, 52428.8, 1e6):
        hj.record(ms)
        ht.record(ms)
    assert (dataclasses.astuple(ht.snapshot())
            == dataclasses.astuple(hj.snapshot()))
    assert len(ht.snapshot().bounds_ms) == 22


def test_traceconfig_validation():
    with pytest.raises(ValueError):
        TraceConfig(deep_trace_every=-1)
    with pytest.raises(ValueError):
        TraceConfig(recall_alpha=0.0)
    with pytest.raises(ValueError):
        TraceConfig(slow_query_ms=-0.5)


def test_chrome_trace_export(tmp_path):
    """Events export as parseable Chrome-trace JSON; the deep-trace stage
    events tile their search's span back-to-back; flush drains."""
    eng = _build("ivf12x4>pq8x64>rr40").tracing(
        trace_dir=str(tmp_path / "traces"), deep_trace_every=1)
    q = _queries()
    for _ in range(3):
        eng.search(q, K)
    path = eng.flush_trace()
    assert path is not None
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    searches = [e for e in events if e["name"] == "search"]
    deep = [e for e in events if e["name"].startswith("deep.")]
    assert len(searches) == 3 and len(deep) == 3 * 4
    for e in events:
        assert e["ph"] == "X" and e["dur"] >= 0.0
    assert searches[0]["args"]["batch"] == 8
    stage_runs = [deep[i:i + 4] for i in range(0, len(deep), 4)]
    for run in stage_runs:                         # sequential tiling
        for a, b in zip(run, run[1:]):
            assert b["ts"] == pytest.approx(a["ts"] + a["dur"], abs=1e-6)
    with open(eng.flush_trace()) as f:
        assert json.load(f)["traceEvents"] == []


def test_slow_query_ring_trims_but_keeps_counting():
    eng = _build("flat").tracing(slow_query_ms=0.0, slow_query_capacity=4)
    q = _queries()
    for _ in range(7):
        eng.search(q, K)
    ring = eng.tracer.slow_query_log()
    assert len(ring) == 4                          # trimmed to capacity
    assert eng.tracer.slow_queries == 7            # counter keeps going
    assert [e["seq"] for e in ring] == [3, 4, 5, 6]   # oldest dropped
    assert ring[-1]["spec"] == "flat"
    quiet = _build("flat").tracing(slow_query_ms=1e9)
    quiet.search(q, K)
    assert quiet.tracer.slow_query_log() == []
    assert quiet.tracer.slow_queries == 0


def test_shadow_recall_is_tombstone_aware():
    """Streaming: an exact flat engine scores recall 1.0 both before and
    after deletes; the shadow truth is built from the LIVE rows."""
    eng = SearchEngine(_data(), ServeConfig(
        index="flat", rerank=128, stream=StreamConfig(delta_capacity=64)),
        device="cpu")
    q = _queries()
    _, ids = eng.search(q, K)
    r, kk = shadow_recall(eng, q, q.shape[0], K, ids)
    assert kk == K and r == pytest.approx(1.0)
    victims = np.unique(ids.numpy()[:, :3].ravel())
    eng.delete(victims)
    _, ids2 = eng.search(q, K)
    assert not np.isin(ids2.numpy(), victims).any()
    r2, kk2 = shadow_recall(eng, q, q.shape[0], K, ids2)
    assert kk2 == K and r2 == pytest.approx(1.0)
    ro = _build("flat")
    _, ids3 = ro.search(q, K)
    r3, kk3 = shadow_recall(ro, q, q.shape[0], K, ids3)
    assert kk3 == K and r3 == pytest.approx(1.0)


def test_recall_gauge_feeds_maintenance_policy():
    """With a policy configured, every shadow sample lands in
    MaintenancePolicy.observe_recall: the EMA the dashboards show."""
    eng = SearchEngine(_data(), ServeConfig(
        index="flat", rerank=128,
        stream=StreamConfig(delta_capacity=64,
                            policy=PolicyConfig(recall_floor=0.5))),
        device="cpu").tracing(recall_every=1)
    q = _queries()
    for _ in range(3):
        eng.search(q, K)
    assert eng._policy.recall_samples == 3
    assert eng._policy.recall_ema == pytest.approx(eng.tracer.recall_ema)
    assert eng.metrics().recall.samples == 3


def test_trace_dir_property_attaches_and_updates(tmp_path):
    eng = _build("flat")
    assert eng.trace_dir is None and eng.flush_trace() is None
    eng.trace_dir = str(tmp_path / "t")
    assert eng.tracer is not None and eng.tracer.active
    eng.search(_queries(), K)
    path = eng.flush_trace()
    with open(path) as f:
        assert len(json.load(f)["traceEvents"]) == 1
    # an all-off config is inert: the serve path takes no timestamp
    idle = _build("flat").tracing(histograms=False)
    assert idle.tracer.active is False
    idle.search(_queries(), K)
    assert idle.tracer.queries == 0


# --- the port's own ----------------------------------------------------------

def test_torch_profile_writes_a_chrome_trace(tmp_path):
    """``torch_profile`` (JAX's ``jax_profile``) writes a Chrome-trace
    JSON of the enclosed block that loads and holds its ops."""
    eng = _build("ivf12x4>pq8x64>rr40")
    q = _queries()
    with torch_profile(str(tmp_path / "prof")) as prof:
        eng.search(q, K)
    names = {e.key for e in prof.key_averages()}
    assert any("topk" in n or "sort" in n for n in names)
    path = os.path.join(str(tmp_path / "prof"),
                        f"qpad_profile_{os.getpid()}.json")
    with open(path) as f:
        doc = json.load(f)
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])


def test_an_inactive_tracer_takes_no_timestamp(monkeypatch):
    """With no tracer, or an inactive one, search never reads the clock
    nor synchronizes: the untraced path."""
    from repro_torch.search import serve, tracing
    calls = []
    real = serve.time.perf_counter
    monkeypatch.setattr(serve.time, "perf_counter",
                        lambda: calls.append(1) or real())
    monkeypatch.setattr(tracing, "_sync", lambda dev: calls.append(2))
    engines = [_build("flat"), _build("flat").tracing(histograms=False),
               _build("flat").tracing()]
    q = _queries()
    calls.clear()
    for eng in engines[:2]:
        eng.search(q, K)
    assert calls == []
    engines[2].search(q, K)                 # the timestamp, the sync, the
    assert calls == [1, 2, 1]               # end timestamp


def test_concurrent_traced_searches_lose_no_update():
    """Eight threads search one traced engine with a short switch
    interval while another scrapes: every search is counted once in the
    histogram, the query counter and the slow-query ring's sequence."""
    import sys
    import threading
    eng = _build("flat").tracing(slow_query_ms=0.0,
                                 slow_query_capacity=1000)
    q = _queries()
    errors = []

    def searcher():
        try:
            for _ in range(25):
                eng.search(q, K)
        except Exception as e:                 # surfaced below
            errors.append(e)

    def scraper():
        try:
            for _ in range(50):
                eng.metrics().flatten()
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=searcher) for _ in range(8)]
        ths.append(threading.Thread(target=scraper))
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ths) and not errors
    m = eng.metrics()
    assert m.latency.queries == m.latency.search.count == 200
    assert m.latency.slow_queries == 200
    assert sorted(e["seq"] for e in eng.tracer.slow_query_log()) == list(
        range(200))


def test_a_kernel_failure_in_a_traced_search_raises(monkeypatch):
    """No fallback: a failing K3 launch in the shadow check, or a failing
    K1 launch in the deep trace's scan stage, raises out of the search
    (here their plain versions stand in for the kernels)."""
    from repro_torch.kernels.pq_adc import ops as adc_ops
    from repro_torch.search import knn

    def fail(*a, **k):
        raise RuntimeError("launch failed")
    eng = _build("ivf12x4>pq8x64:i8@kernel>rr64").tracing(recall_every=1)
    q = _queries()
    eng.search(q, K)
    monkeypatch.setattr(knn, "knn_scan", fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.search(q, K)
    monkeypatch.undo()
    eng.tracing(deep_trace_every=1)
    eng.search(q, K)                          # warms the deep trace
    monkeypatch.setattr(adc_ops, "pq_adc_cells_topk", fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        deep_trace(eng, q, K, _kw(eng))


def test_slow_query_seq_is_the_searchs_own():
    """Two searches that both started before either committed: the port
    numbers each slow-query entry by its own place in the count; JAX's
    ``Tracer`` reads the counter at commit time and gives both the same
    ``seq`` (a reference behaviour; one thread at a time, they agree)."""
    from repro.search import build_engine as jax_build_engine
    from repro.search.tracing import TraceConfig as JTraceConfig
    from repro.search.tracing import Tracer as JTracer
    kw = _kw(_build("flat"))
    seqs = {}
    for name, tracer, eng in (
            ("jax", JTracer(JTraceConfig(slow_query_ms=0.0)),
             jax_build_engine(_data(), "flat")),
            ("port", None, _build("flat"))):
        if tracer is None:
            tracer = eng.tracing(slow_query_ms=0.0).tracer
        eng.last_bucket = 8
        tracer.queries = 2                       # both searches counted
        for n in (0, 1):
            args = (eng, 8, K, kw, 0.0, 1.0, None, None)
            if name == "port":
                tracer._commit(eng, n, *args[1:])
            else:
                tracer._commit(*args)
        seqs[name] = [e["seq"] for e in tracer.slow_query_log()]
    assert seqs == {"jax": [1, 1], "port": [0, 1]}


# --- held against JAX's ------------------------------------------------------

def _state_arrays(state):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _jax_kw(eng):
    cfg = eng.config
    probed = cfg.index in ("ivf", "ivfpq")
    coded = cfg.index in ("pq", "opq", "ivfpq")
    return dict(nprobe=cfg.nprobe if probed else 0, rerank=cfg.rerank,
                backend=cfg.pq_backend if coded else "jnp",
                interpret=cfg.pq_interpret if coded else True,
                lut_dtype=cfg.lut_dtype if coded else "f32",
                scan_cap=0, prefilter=0)


@pytest.mark.parametrize("spec", ["flat", "qpad8>rr64", "ivf12x4",
                                  "pq8x64>rr64", "opq8x64>rr64",
                                  "ivf12x4>pq8x64:i8>rr64",
                                  "ivf12x4>pq8x64:i8@kernel>rr64"])
def test_deep_trace_and_shadow_recall_match_jax(spec):
    """A JAX engine and the port's over the same arrays: the deep trace's
    stage names are JAX's and sum within 10%, traced searches return the
    untraced ids, and shadow_recall equals JAX's on the same served
    batch."""
    pytest.importorskip("jax")
    from repro.core import MPADConfig as JConfig
    from repro.search import build_engine as jax_build_engine
    from repro.search import deep_trace as jax_deep_trace
    from repro.search.tracing import shadow_recall as jax_shadow_recall
    kw = {"mpad": JConfig(m=8, iters=8)} if spec.startswith("qpad") else {}
    jeng = jax_build_engine(_data(), spec, fit_sample=512, **kw)
    state = state_from_arrays(_state_arrays(jeng.state), spec, device="cpu")
    plain = SearchEngine.from_state(state, config_from_spec(spec))
    traced = SearchEngine.from_state(state, config_from_spec(spec)).tracing(
        deep_trace_every=1, recall_every=1)
    q = _queries(n=16)
    qn = q.numpy()
    jout = jax_deep_trace(jeng, qn, K, _jax_kw(jeng))
    tout = deep_trace(plain, q, K, _kw(plain))
    assert [s for s, _ in tout["stages"]] == [s for s, _ in jout["stages"]]
    _within_10pct(tout)
    d0, i0 = plain.search(q, K)
    d1, i1 = traced.search(q, K)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    assert traced.compile_count == plain.compile_count
    _, ij = jeng.search(qn, K)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ij))
    rj, kj = jax_shadow_recall(jeng, qn, 16, K, ij)
    rt, kt = shadow_recall(plain, q, 16, K, i0)
    assert kt == kj and rt == pytest.approx(rj, abs=1e-6)
    assert traced.tracer.recall_last == pytest.approx(rj, abs=1e-6)


@pytest.mark.parametrize("spec", ["flat>rr128", "ivf12x4>pq8x64:i8>rr128"])
def test_streaming_shadow_recall_matches_jax(spec):
    """The same store through both packages, the same writes and deletes:
    tombstone-aware shadow recall equals JAX's, and the deleted ids are in
    neither the served ids nor the truth."""
    jax = pytest.importorskip("jax")
    from repro.search import StreamConfig as JStreamConfig
    from repro.search import build_engine as jax_build_engine
    from repro.search.tracing import shadow_recall as jax_shadow_recall
    scfg = dict(delta_capacity=64)
    jeng = jax_build_engine(_data(), spec, stream=JStreamConfig(**scfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        {"store": jeng.store, "frozen": jeng.frozen})
    arrays = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    ts, tf = stream_from_arrays(arrays, spec, device="cpu")
    teng = SearchEngine.from_store(ts, tf, config_from_spec(
        spec, stream=StreamConfig(**scfg))).tracing(recall_every=1)
    q = _queries(n=16)
    qn = q.numpy()
    _, ids = teng.search(q, K)
    victims = np.unique(ids.numpy()[:, :2].ravel())
    new = _data(seed=5, n=20)
    for e in (jeng, teng):
        e.upsert(np.arange(700, 720), new)
        e.delete(victims)
    _, ij = jeng.search(qn, K)
    _, it = teng.search(q, K)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert not np.isin(it.numpy(), victims).any()
    rj, kj = jax_shadow_recall(jeng, qn, 16, K, ij)
    rt, kt = shadow_recall(teng, q, 16, K, it)
    assert kt == kj == K and rt == pytest.approx(rj, abs=1e-6)
    assert teng.tracer.recall_samples == 2
    assert teng.tracer.recall_last == pytest.approx(rj, abs=1e-6)


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_traced_search_counts_k1_and_k3():
    """On the card a traced ivfpq@kernel search launches K1's cell-major
    entry, its deep trace's scan stage launches it again (after one warm
    pass), and its shadow check launches K3 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels.knn_topk import ops as k3
    from repro_torch.kernels.pq_adc import ops as adc_ops
    spec = "ivf12x4>pq8x64:i8@kernel>rr64"
    plain = build_engine(_data(), spec, device="cuda", compact_batch=0)
    traced = SearchEngine.from_state(plain.state, plain.config).tracing(
        deep_trace_every=1, recall_every=1)
    q = _queries(n=64).cuda()
    d0, i0 = plain.search(q, K)
    c1, c3 = adc_ops.pq_adc_cells_topk.launches, k3.knn_topk_d2.launches
    d1, i1 = traced.search(q, K)
    torch.cuda.synchronize()
    # the search, the deep trace's warm pass and its timed pass
    assert adc_ops.pq_adc_cells_topk.launches == c1 + 3
    assert k3.knn_topk_d2.launches == c3 + 1
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    assert traced.tracer.recall_samples == 1


@pytest.mark.gpu
def test_cuda_streaming_shadow_recall_on_k3():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels.knn_topk import ops as k3
    eng = SearchEngine(_data(), ServeConfig(
        index="flat", rerank=128, stream=StreamConfig(delta_capacity=64)),
        device="cuda").tracing(recall_every=1)
    q = _queries().cuda()
    eng.delete(np.arange(0, 50))
    c3 = k3.knn_topk_d2.launches
    eng.search(q, K)
    torch.cuda.synchronize()
    assert k3.knn_topk_d2.launches == c3 + 1     # the shadow check alone
    assert eng.tracer.recall_last == pytest.approx(1.0)
