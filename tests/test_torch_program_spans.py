"""The program spans and the host-sync counter of
``repro_torch.search.tracing`` (``span`` / ``count``): off while no
profiler records (no ``record_function`` call, nothing recorded), on under
``torch.profiler`` (the stage spans of the path that serves with their
parents, one request id a call, self times, syncs charged to the innermost
span), answers bit for bit the same either way, and the stages nested in
``qpad.search`` in ``torch_profile``'s trace. The ``gpu`` tests hold the
counter against ``torch.cuda.set_sync_debug_mode("warn")`` and the stages'
device time against the profiler's busy time on the card.

No JAX here: the card's tests run in this file too."""
import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.search import (SearchEngine, StreamConfig,  # noqa: E402
                                build_engine, segments, serve, tracing)

K = 10
SPEC = "qpad8>ivf16x4>pq4x64:i8@kernel>rr32"
SEARCH_STAGES = {"search.project", "search.probe", "search.scan",
                 "search.rerank"}
STREAM_STAGES = SEARCH_STAGES | {"search.live_map", "search.delta_scan",
                                 "search.merge"}


def _data(n=3000, d=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2
    lab = rng.integers(0, 12, n)
    return (centers[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _fresh_session():
    """A span site run with the profiler off: the next profiled site
    starts a new session."""
    with tracing.span("idle"):
        pass


def _engine(device="cpu", stream=None, **kw):
    return build_engine(_data(), SPEC, device=device, stream=stream, **kw)


@pytest.fixture(scope="module")
def built():
    """The read-only engine on the CPU (searches leave it as it was)."""
    return _engine()


def _streaming(eng):
    """A streaming engine over a copy of ``eng``'s state (no new fit)."""
    return SearchEngine.from_state(eng.state, dataclasses.replace(
        eng.config, stream=StreamConfig(delta_capacity=64)))


def _write_inputs(step, device="cpu"):
    """One write step's inputs on ``device``: 40 rows to upsert (half of
    them fresh ids), 10 ids to delete."""
    x = torch.from_numpy(_data(n=40, seed=10 + step)).to(device)
    ids = torch.cat([torch.arange(100 * step, 100 * step + 20),
                     torch.arange(5000 + 20 * step, 5020 + 20 * step)])
    dels = torch.arange(2000 + 10 * step, 2010 + 10 * step)
    return ids.to(device), x, dels.to(device)


def _write_step(eng, step, device="cpu", inputs=None):
    """One write step (``_write_inputs``)."""
    ids, x, dels = inputs or _write_inputs(step, device)
    eng.upsert(ids, x)
    eng.delete(dels)


def _queries(n=64, device="cpu"):
    return torch.from_numpy(_data(n=n, seed=3)).to(device)


def _by_sid(spans):
    return {sp.sid: sp for sp in spans}


# --- off: the untraced path --------------------------------------------------

def test_no_profiler_no_record_function_and_nothing_recorded(monkeypatch,
                                                              built):
    eng, st = built, _streaming(built)
    q = _queries()
    calls = []
    real = torch.autograd.profiler.record_function

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the recorder was reached with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    monkeypatch.setattr(tracing.RECORDER, "open", refuse)
    monkeypatch.setattr(tracing.RECORDER, "count", refuse)
    eng.search(q, K)
    _write_step(st, 0)
    st.search(q, K)
    st.compact()
    assert calls == []


def test_count_and_span_are_no_ops_off():
    before = tracing.snapshot()
    with tracing.span("search") as sp:
        tracing.count("host_syncs", 5)
    assert sp is None
    assert tracing.snapshot() == before


# --- on: the spans of the path that serves -----------------------------------

def test_search_spans_parents_request_and_self_time():
    eng = _engine()                  # its compact-scan width not read yet
    q = _queries()
    _fresh_session()
    with _profiled():
        eng.search(q, K)
        eng.search(q[:8], K)
    spans = tracing.RECORDER.recent_spans()
    roots = [sp for sp in spans if sp.name == "search"]
    assert len(roots) == 2 and all(r.parent is None for r in roots)
    assert len({r.request for r in roots}) == 2
    sids = _by_sid(spans)
    for root in roots:
        kids = [sp for sp in spans if sp.parent == root.sid]
        assert {sp.name for sp in kids} == SEARCH_STAGES
        assert all(sp.request == root.request for sp in kids)
        covered = sum(sp.t1 - sp.t0 for sp in kids)
        assert root.self_ms == pytest.approx(
            (root.t1 - root.t0 - covered) * 1e3, abs=1e-9)
        assert 0.0 <= root.self_ms < root.host_ms
        for sp in kids:
            assert root.t0 <= sp.t0 <= sp.t1 <= root.t1
            assert sids[sp.parent] is root
    stats = tracing.snapshot()
    assert stats["search"].count == 2
    for name in SEARCH_STAGES:
        assert stats[name].count == 2
        # on the CPU the device interval is the host interval
        assert stats[name].device_ms == pytest.approx(stats[name].host_ms)
    # both buckets take the compact scan: its width is read back once
    assert stats["search"].syncs == 1


def test_write_spans_and_syncs_charged_to_the_innermost_span(built):
    st = _streaming(built)
    _fresh_session()
    with _profiled():
        _write_step(st, 0)
        _write_step(st, 1)         # its upsert passes the compact point
    spans = tracing.RECORDER.recent_spans()
    sids = _by_sid(spans)
    names = [sp.name for sp in spans if sp.parent is None]
    assert names == ["write.upsert", "write.delete"] * 2
    assert len({sp.request for sp in spans if sp.parent is None}) == 4
    for sp in spans:
        if sp.parent is not None:
            up = sids[sp.parent]
            assert up.name in ("write.upsert", "write.delete")
            assert sp.request == up.request
    compacts = [sp for sp in spans if sp.name == "write.compact"]
    assert len(compacts) == 1
    assert sids[compacts[0].parent].name == "write.upsert"
    # bool(ok), nonzero and int(dropped)
    assert compacts[0].counts == {"host_syncs": 3}
    tomb = [sp for sp in spans if sp.name == "write.tombstone"]
    assert [sids[sp.parent].name for sp in tomb] == [
        "write.upsert", "write.delete"] * 2
    # the isin over the row ids (and, in a delete, over the delta ids)
    # takes the sorted route at these sizes: three syncs each
    assert [sp.counts["host_syncs"] for sp in tomb] == [3, 6, 3, 6]
    for sp in spans:
        if sp.name in ("write.upsert", "write.delete"):
            assert sp.counts == {}
    stats = tracing.snapshot()
    assert stats["write.tombstone"].syncs == 18
    assert stats["write.upsert"].syncs == 0


def test_streaming_search_spans(built):
    st = _streaming(built)
    _write_step(st, 0)
    _fresh_session()
    with _profiled():
        st.search(_queries(), K)
    spans = tracing.RECORDER.recent_spans()
    (root,) = [sp for sp in spans if sp.parent is None]
    assert root.name == "search"
    kids = [sp.name for sp in spans if sp.parent == root.sid]
    assert set(kids) == STREAM_STAGES
    # the live map of the rows, then the probed cells' map of it
    assert kids.count("search.live_map") == 2
    assert tracing.snapshot()["search"].syncs == 0


def test_counts_charged_to_the_innermost_open_span():
    _fresh_session()
    with _profiled():
        with tracing.span("a"):
            tracing.count("host_syncs")
            with tracing.span("a.b"):
                tracing.count("host_syncs", 2)
                with tracing.span("a.b.c"):
                    pass
            tracing.count("other")
        tracing.count("host_syncs", 4)        # outside any span
    stats = tracing.snapshot()
    assert stats["a"].counts == {"host_syncs": 1, "other": 1}
    assert stats["a.b"].syncs == 2 and stats["a.b.c"].syncs == 0
    assert stats[""].syncs == 4
    a, ab = stats["a"], stats["a.b"]
    assert a.self_ms == pytest.approx(a.host_ms - ab.host_ms, abs=1e-6)


def test_a_new_profiler_session_starts_afresh(built):
    eng = built
    q = _queries()
    _fresh_session()
    with _profiled():
        eng.search(q, K)
    assert tracing.snapshot()["search"].count == 1
    eng.search(q, K)                   # a site finds the profiler off
    with _profiled():
        eng.search(q, K)
        eng.search(q, K)
    assert tracing.snapshot()["search"].count == 2


def test_isin_counts_the_sorting_route(monkeypatch):
    seen = []
    monkeypatch.setattr(segments, "count", lambda n, k=1: seen.append(k))
    elements = torch.arange(10_000)
    cut = int(10.0 * 10_000 ** 0.145)          # 38
    for m, syncs in ((cut - 1, []), (cut, [3])):
        seen.clear()
        test = torch.arange(m) * 3
        assert torch.equal(segments._isin(elements, test),
                           torch.isin(elements, test))
        assert seen == syncs
    seen.clear()
    segments._isin(torch.arange(0), torch.arange(100))
    assert seen == []


def test_a_copy_between_devices_counts_a_sync(monkeypatch):
    seen = []
    monkeypatch.setattr(serve, "count", lambda n, k=1: seen.append(n))
    x = np.arange(6, dtype=np.int64)
    t = serve._on_device(x, torch.int64, torch.device("cpu"))
    assert seen == [] and t.device.type == "cpu"
    t = serve._on_device(x, torch.int64, torch.device("meta"))
    assert seen == ["host_syncs"] and t.device.type == "meta"


# --- the answers do not move -------------------------------------------------

def test_answers_and_programs_are_the_same_with_spans_on(built):
    """The same searches of one read-only engine, then the same writes
    and searches of two streaming engines over one state: off, then
    on."""
    s_off, s_on = _streaming(built), _streaming(built)
    q = _queries()
    results = {}
    for name, eng, st, profiled in (("off", built, s_off, False),
                                    ("on", built, s_on, True)):
        _fresh_session()
        with (_profiled() if profiled else contextlib.nullcontext()):
            out = [eng.search(q, K), eng.search(q[:5], K)]
            for step in range(3):
                _write_step(st, step)
                out.append(st.search(q, K))
        results[name] = (out, eng.compile_count, st.compile_count,
                         st.counters["compactions"])
    (o_out, *o_counts), (n_out, *n_counts) = results["off"], results["on"]
    assert o_counts == n_counts
    for (d0, i0), (d1, i1) in zip(o_out, n_out):
        assert torch.equal(d0, d1) and torch.equal(i0, i1)
    for f in s_off.store._fields:
        a, b = getattr(s_off.store, f), getattr(s_on.store, f)
        assert (a is None and b is None) or torch.equal(a, b), f


# --- torch_profile's trace ---------------------------------------------------

def test_torch_profile_trace_nests_the_stages_in_the_search(tmp_path,
                                                            built):
    eng = built
    q = _queries()
    _fresh_session()
    with tracing.torch_profile(str(tmp_path)):
        eng.search(q, K)
        eng.search(q, K)
    path = os.path.join(str(tmp_path), f"qpad_profile_{os.getpid()}.json")
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith("qpad.")]
    roots = [e for e in events if e["name"] == "qpad.search"]
    stages = [e for e in events if e["name"].startswith("qpad.search.")]
    assert len(roots) == 2
    assert {e["name"][len("qpad."):] for e in stages} == SEARCH_STAGES
    assert len(stages) == 2 * len(SEARCH_STAGES)
    for e in stages:
        assert any(r["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= r["ts"] + r["dur"]
                   for r in roots), e["name"]


# --- threads -----------------------------------------------------------------

def test_concurrent_searches_keep_their_own_stacks():
    """Eight threads search one engine under the profiler with a short
    switch interval: every search is one root whose stages are its
    children, on its thread, with its request id."""
    eng = build_engine(_data(n=600), "flat", device="cpu")
    q = _queries(n=8)
    errors = []

    def searcher():
        try:
            for _ in range(10):
                eng.search(q, K)
        except Exception as e:                 # surfaced below
            errors.append(e)

    _fresh_session()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            ths = [threading.Thread(target=searcher) for _ in range(8)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ths) and not errors
    spans = tracing.RECORDER.recent_spans()
    sids = _by_sid(spans)
    roots = [sp for sp in spans if sp.parent is None]
    assert len(roots) == 80 and {sp.name for sp in roots} == {"search"}
    assert len({sp.request for sp in roots}) == 80
    for sp in spans:
        if sp.parent is not None:
            up = sids[sp.parent]
            assert up.name == "search" and up.thread == sp.thread
            assert up.request == sp.request
    stats = tracing.snapshot()
    assert stats["search"].count == 80
    assert stats["search.scan"].count == 80


# --- on the card -------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _total_syncs(stats):
    return sum(s.syncs for s in stats.values())


def _sync_warnings(caught):
    return [w for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


@pytest.mark.gpu
def test_cuda_sync_counter_equals_the_sync_debug_warnings():
    """Over one read-only search and one write step of a small streaming
    engine (with a compaction, a streaming search and a delete given as
    a host array, whose copy waits), the counter rises by the warnings
    ``set_sync_debug_mode("warn")`` raises."""
    _needs_card()
    ro = _engine(device="cuda")
    st = _engine(device="cuda", stream=StreamConfig(delta_capacity=64))
    q = _queries(device="cuda")
    for eng in (ro, st):             # warm: the kernels' first builds
        eng.search(q, K)
    _write_step(st, 0, "cuda")
    inputs = _write_inputs(1, "cuda")   # made before: the copies wait
    torch.cuda.synchronize()
    _fresh_session()
    with _profiled():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ro.search(q, K)
                _write_step(st, 1, inputs=inputs)
                st.compact()
                st.search(q, K)
                st.delete(np.arange(2500, 2510))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        stats = tracing.snapshot()
    syncs = _sync_warnings(caught)
    assert _total_syncs(stats) == len(syncs), (
        {k: v.counts for k, v in stats.items() if v.counts},
        [f"{w.filename}:{w.lineno}" for w in syncs])
    # the upsert's compaction and compact()'s: bool(ok), nonzero and
    # int(dropped) each
    assert stats["write.compact"].syncs == 6


@pytest.mark.gpu
def test_cuda_read_only_ivfpq_search_at_1024_makes_no_host_sync():
    _needs_card()
    eng = _engine(device="cuda")
    q = _queries(n=1024, device="cuda")
    eng.search(q, K)
    torch.cuda.synchronize()
    _fresh_session()
    with _profiled():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.search(q, K)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        stats = tracing.snapshot()
    assert eng.last_bucket == 1024
    assert _total_syncs(stats) == 0
    assert not _sync_warnings(caught)


def _queued_searches(tmp_path):
    """A profiled window of a read-only engine whose searches are all
    queued behind a spin kernel (the host enqueues them before the card
    reaches the first): the stages' device ms summed, and the trace's
    kernels, copies and sets over the searches. A trace that lost one of
    K1's launches is taken again, as ``bench/trace.py`` does."""
    _needs_card()
    from repro_torch.kernels.pq_adc import ops as adc_ops
    eng = build_engine(_data(n=400_000, d=128), "qpad32>ivf256x32>"
                       "pq16x256:i8@kernel>rr64", device="cuda")
    q = _queries(n=1024, device="cuda").repeat(1, 4)
    for _ in range(2):
        eng.search(q, K)
    torch.cuda.synchronize()
    # few enough that the card's launch queue holds them all
    batches = 8
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    spin = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for attempt in range(3):
        _fresh_session()
        k1 = adc_ops.pq_adc_cells_topk.launches
        with torch.profiler.profile(activities=acts) as prof:
            spin[0].record()
            torch.cuda._sleep(1_000_000_000)    # ~0.5 s of work ahead
            spin[1].record()
            t0 = time.perf_counter()
            for _ in range(batches):
                eng.search(q, K)
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        assert enqueue_ms < spin[0].elapsed_time(spin[1])
        stats = tracing.snapshot()
        path = str(tmp_path / f"trace{attempt}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in (
                      "kernel", "gpu_memcpy", "gpu_memset")
                  and "spin_kernel" not in e["name"]]
        launched = adc_ops.pq_adc_cells_topk.launches - k1
        if sum("adc_select" in e["name"] for e in ev) == launched:
            break
    assert launched == batches
    assert stats["search"].count == batches
    stage_ms = sum(s.device_ms for n, s in stats.items()
                   if n.startswith("search."))
    return stage_ms, ev


def _busy_ms(ev):
    """The union of the events' intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for e in sorted(ev, key=lambda e: float(e["ts"])):
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        s = max(s, end)
        if t > s:
            busy += t - s
            end = t
    return busy / 1e3


@pytest.mark.gpu
def test_cuda_stage_device_time_matches_the_trace_busy_time(tmp_path):
    """In a profiled window of a read-only engine whose searches are all
    queued behind a spin kernel (the host enqueues them before the card
    reaches the first), the stages' device ms sum to within 10% of the
    trace's busy time over the searches (the union of every other
    kernel, copy and set). A trace that lost one of K1's launches is
    taken again, as ``bench/trace.py`` does."""
    stage_ms, ev = _queued_searches(tmp_path)
    busy_ms = _busy_ms(ev)
    assert abs(stage_ms - busy_ms) <= 0.10 * busy_ms, (stage_ms, busy_ms)


@pytest.mark.gpu
def test_cuda_stage_device_time_matches_the_queued_window(tmp_path):
    """Over the same queued searches the stages' device ms lie within 5%
    of the card's time from the searches' first kernel's start to their
    last one's end, and at or above the trace's busy time: a span runs
    between CUDA events, so it holds the card's own gaps between queued
    kernels, which the busy time leaves out."""
    stage_ms, ev = _queued_searches(tmp_path)
    window_ms = (max(float(e["ts"]) + float(e["dur"]) for e in ev)
                 - min(float(e["ts"]) for e in ev)) / 1e3
    assert _busy_ms(ev) <= stage_ms, (stage_ms, _busy_ms(ev))
    assert abs(stage_ms - window_ms) <= 0.05 * window_ms, (stage_ms,
                                                           window_ms)
