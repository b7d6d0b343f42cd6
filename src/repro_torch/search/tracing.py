"""Request-level tracing: per-query timing, deep per-stage attribution,
slow-query capture, online recall estimation, and stage spans inside the
serving path (port of ``repro.search.tracing``, plus the spans).

A host timer around one ``SearchEngine.search`` call sees only the
end-to-end latency. This module layers four opt-in instruments on top
of that single number:

- **Latency histograms** (``TraceConfig(histograms=True)``): every search
  records its synchronized end-to-end wall time into a fixed-boundary
  log-spaced histogram (``LatencyHistogram``); ``engine.metrics()`` then
  derives p50/p95/p99 under ``latency.search.*`` and the Prometheus
  endpoint renders a real ``histogram`` series.
- **Sampled deep trace** (``deep_trace_every=N``): 1-in-N queries re-run
  through a *staged* pipeline, project / probe / scan / re-rank as
  separate calls with a device synchronization between stages, for
  non-overlapping per-stage attribution that sums to the staged run's
  own end-to-end time by construction. The stages never pass through the
  engine's programs, so sampling never moves ``compile_count``.
- **Slow-query log** (``slow_query_ms=T``): a ring buffer of the worst
  offenders: spec, batch shape, bucket, knob fan-out, stage timings
  when a deep trace rode the same query.
- **Shadow recall** (``recall_every=N``): 1-in-N queries are re-answered
  exactly (``knn_search`` against the live rows, tombstone-aware on
  streaming engines; kernel K3 on the card) and the observed recall@k
  feeds a ``recall.estimate_at_k`` EMA gauge plus, on a streaming
  engine, ``MaintenancePolicy.observe_recall``.
- **Program spans** (``span`` / ``count``, process-wide, one
  ``SpanRecorder``): the path that serves opens a span at every stage
  boundary (``search`` and its children ``search.project``,
  ``search.probe``, ``search.live_map``, ``search.scan``,
  ``search.delta_scan``, ``search.merge``, ``search.rerank``; the writes
  ``write.upsert`` and ``write.delete``, their ``write.tombstone`` and a
  ``write.compact`` one of them triggers) and counts ``host_syncs`` where
  it makes the host wait for the device, charged to the innermost open
  span. The switch is the PyTorch profiler itself: spans record only
  while a ``torch.profiler`` session records (``torch_profile``, or a
  benchmark's traced window). Off, a site costs one read of the
  profiler's module flag (and a span site one store of a module flag):
  no timestamp, no record, no ``record_function`` call, no synchronize.
  On, a span opens ``record_function("qpad.<name>")`` (its request id as
  the ``args``), so the stage lies in the profiler's trace on the
  kernels' clock, and records its host interval, its parent (a
  per-thread stack), a request id shared by every span of one
  ``search`` / ``upsert`` / ``delete`` call, and a CUDA event at each
  end on the current stream (no synchronize); ``snapshot()`` resolves
  the device intervals (on the CPU the host interval stands for it) and
  returns per-name aggregates (count, host ms, self ms, device ms and
  counters) of the newest profiler session: the recorder starts afresh
  when a site finds the profiler on after one found it off.

The first four funnel through one ``Tracer`` attached by
``engine.tracing(...)``; with every feature off ``Tracer.active`` is
False and the serve path skips even the timestamp. Chrome-trace /
Perfetto JSON export (``trace_dir=``) covers host-side spans; for
device-side kernel timelines use the ``torch_profile`` context manager
(a ``torch.profiler`` trace written as Chrome-trace JSON), under which
the program spans record too.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Mapping, Optional

import torch

from .metrics import HistogramSnapshot, LatencyMetrics, RecallMetrics

__all__ = ["TraceConfig", "Tracer", "LatencyHistogram", "deep_trace",
           "shadow_recall", "torch_profile", "span", "count", "snapshot",
           "SpanStats", "Span", "SpanRecorder", "RECORDER"]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Log-spaced upper bounds in milliseconds: 0.05 ms .. ~105 s doubling, the
# JAX package's bounds. Fixed boundaries keep recording O(log n_buckets)
# (a bisect) and make snapshots mergeable across engines and packages.
_BOUNDS_MS = tuple(0.05 * 2.0 ** i for i in range(22))


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs for one ``Tracer``. Everything defaults off except the
    histograms: ``SearchEngine.tracing()`` with no arguments gives the
    cheap always-on production posture (end-to-end histograms only)."""
    histograms: bool = True          # e2e latency histogram accumulation
    trace_dir: Optional[str] = None  # Chrome-trace JSON export directory
    slow_query_ms: Optional[float] = None   # ring-buffer capture threshold
    slow_query_capacity: int = 64
    deep_trace_every: int = 0        # 1-in-N staged re-runs (0 = off)
    recall_every: int = 0            # 1-in-N shadow-exact checks (0 = off)
    recall_alpha: float = 0.1        # EMA coefficient for the recall gauge
    max_events: int = 16384          # Chrome-trace event ring capacity

    def __post_init__(self):
        if self.deep_trace_every < 0 or self.recall_every < 0:
            raise ValueError("deep_trace_every/recall_every must be >= 0")
        if not 0.0 < self.recall_alpha <= 1.0:
            raise ValueError("recall_alpha must be in (0, 1]")
        if self.slow_query_ms is not None and self.slow_query_ms < 0:
            raise ValueError("slow_query_ms must be >= 0")


class LatencyHistogram:
    """Fixed-boundary log-spaced latency accumulator (milliseconds).

    ``record`` is a bisect and two adds, cheap enough for the per-search
    hot path; ``snapshot`` freezes to ``metrics.HistogramSnapshot``
    (bounds, per-bucket counts with a trailing overflow bucket, sum,
    count), which the metrics layer derives percentiles from and renders
    as a Prometheus histogram."""

    __slots__ = ("counts", "sum_ms", "count")

    def __init__(self):
        self.counts = [0] * (len(_BOUNDS_MS) + 1)
        self.sum_ms = 0.0
        self.count = 0

    def record(self, ms: float):
        self.counts[bisect.bisect_left(_BOUNDS_MS, ms)] += 1
        self.sum_ms += ms
        self.count += 1

    def snapshot(self) -> HistogramSnapshot:
        return HistogramSnapshot(bounds_ms=_BOUNDS_MS,
                                 counts=tuple(self.counts),
                                 sum_ms=self.sum_ms, count=self.count)


# --- staged pipeline (deep trace) --------------------------------------------

def deep_trace(engine, queries, k: int, kw: Mapping) -> Optional[dict]:
    """Run one batch through the staged pipeline, timing each stage.

    ``queries`` is the engine's already-padded bucket batch and ``kw`` the
    knob dict ``SearchEngine.search`` dispatched with, so the
    decomposition describes the shapes the search ran. ivfpq decomposes as
    project/probe/scan/rerank (``ivfpq_probe`` and
    ``ivfpq_scan_given_probe``, the search's own probe and scan: K1's
    cell-major entry on the cells' fills, with no candidate-id table, on
    ``backend="kernel"``); other kinds as
    project/scan/rerank. Only unsharded read-only engines qualify
    (``engine.state``); returns None otherwise.

    Returns ``{"stages": [(name, ms), ...], "e2e_ms": float}``: the stage
    list is ordered, non-overlapping, and sums to ``e2e_ms`` up to the
    host's work between stages (the acceptance bound: within 10%). The
    first run at a (shape, kind, knobs) key is an untimed warm pass, so a
    kernel's first call at a shape is never timed.
    """
    from .ivfpq import ivfpq_probe, ivfpq_scan_given_probe
    from .reducers import reduce_vectors
    from .registry import ScanParams, get_ops
    from .serve import exact_rerank
    state = engine.state
    if (state is None or engine.store is not None
            or engine.sharded_state is not None):
        return None
    kind = state.index.kind
    ops = get_ops(kind)
    approximate = state.proj is not None or ops.lossy
    n_cand = kw["rerank"] if approximate else k
    device = queries.device

    def _run():
        stages = []
        t0 = time.perf_counter()
        qr = reduce_vectors(state.proj, queries.to(torch.float32))
        _sync(device)
        t1 = time.perf_counter()
        stages.append(("project", (t1 - t0) * 1e3))
        if kind == "ivfpq":
            ix = state.index.payload
            probe, cand0, cd2p, cell_len = ivfpq_probe(
                ix.centroids, ix.lists, qr, kw["nprobe"], n_cand,
                kw["backend"])
            _sync(device)
            t2 = time.perf_counter()
            stages.append(("probe", (t2 - t1) * 1e3))
            _, cand = ivfpq_scan_given_probe(
                probe, cand0, cd2p, ix.codes_cell, ix.bias_cell, ix.lut_w,
                ix.cbnorm, ix.codebooks, qr, n_cand, backend=kw["backend"],
                lut_dtype=kw["lut_dtype"], cell_len=cell_len, lists=ix.lists)
            _sync(device)
            t3 = time.perf_counter()
            stages.append(("scan", (t3 - t2) * 1e3))
        else:
            p = ScanParams(nprobe=kw["nprobe"], backend=kw["backend"],
                           lut_dtype=kw["lut_dtype"])
            _, cand = ops.scan(state, qr, n_cand, p)
            _sync(device)
            t3 = time.perf_counter()
            stages.append(("scan", (t3 - t1) * 1e3))
        exact_rerank(queries, state.corpus, cand, k)
        _sync(device)
        t4 = time.perf_counter()
        stages.append(("rerank", (t4 - t3) * 1e3))
        return {"stages": stages, "e2e_ms": (t4 - t0) * 1e3}

    warm_key = (tuple(queries.shape), kind, kw["nprobe"], kw["backend"],
                kw["lut_dtype"], n_cand, k)
    if warm_key not in engine._deep_warm:      # never time a first call
        _run()
        engine._deep_warm.add(warm_key)
    return _run()


# --- shadow-exact recall -----------------------------------------------------

def shadow_recall(engine, queries, nq: int, k: int, ids) -> Optional[tuple]:
    """Brute-force the same batch against the live rows and score the
    served ids: returns (recall@k', k') or None when no row is live.
    Streaming engines are checked tombstone-aware through
    ``_gather_live`` (base survivors and live delta rows, mapped to
    external ids); read-only engines against ``state.corpus`` (row index
    == external id). k' = min(k, live rows). Both exact searches are
    ``knn_search``: kernel K3 on the card, one launch a check."""
    from .knn import knn_search, recall_at_k
    queries = queries[:nq]
    if engine.store is not None:
        vecs, ext = engine._gather_live()
        if ext.shape[0] == 0:
            return None
        kk = min(k, ext.shape[0])
        _, idx = knn_search(queries, vecs.to(torch.float32), kk)
        truth = ext[idx]
    elif engine.state is not None:
        corpus = engine.state.corpus
        kk = min(k, corpus.shape[0])
        _, truth = knn_search(queries, corpus, kk)
    else:
        return None
    return float(recall_at_k(ids[:nq, :kk], truth)), kk


# --- the tracer --------------------------------------------------------------

class Tracer:
    """Per-engine trace state: histograms, slow-query ring, Chrome-trace
    events, recall EMA. Attached by ``SearchEngine.tracing()``; the serve
    path calls ``on_search`` after dispatching the search. Thread-safe
    against concurrent ``MetricsServer`` scrapes (one lock around all
    mutation and snapshotting)."""

    def __init__(self, config: TraceConfig = TraceConfig()):
        self.config = config
        self._lock = threading.Lock()
        self._e2e = LatencyHistogram()
        self._stages: dict = {}          # stage name -> LatencyHistogram
        self._slow: list = []            # ring buffer of slow-query dicts
        self._events: list = []          # Chrome-trace events (capped)
        self._origin = time.perf_counter()
        self.queries = 0                 # search calls seen
        self.slow_queries = 0            # total over-threshold (>= ring)
        self.deep_traces = 0
        self.recall_ema: Optional[float] = None
        self.recall_last: Optional[float] = None
        self.recall_k: Optional[int] = None
        self.recall_samples = 0

    @property
    def active(self) -> bool:
        """True when any instrument is on (the serve path then takes its
        timestamp and synchronizes)."""
        c = self.config
        return bool(c.histograms or c.trace_dir is not None
                    or c.slow_query_ms is not None
                    or c.deep_trace_every or c.recall_every)

    # -- recording ----------------------------------------------------------

    def on_search(self, engine, queries, nq: int, k: int, kw: Mapping,
                  t0: float, d, ids):
        """Finish one traced search: synchronize, time, and run whichever
        instruments sampled this call. ``queries`` is the padded bucket
        batch; ``t0`` the host timestamp the engine took before dispatch;
        ``d``/``ids`` the full-bucket result. The synchronization makes
        the recorded time an end-to-end one (the caller's own
        synchronization then finds nothing left to wait for)."""
        c = self.config
        _sync(ids.device)
        t1 = time.perf_counter()
        e2e_ms = (t1 - t0) * 1e3
        with self._lock:
            n = self.queries
            self.queries += 1
        trace = (c.deep_trace_every
                 and n % c.deep_trace_every == 0) or None
        if trace:
            trace = deep_trace(engine, queries, k, kw)
        shadow = None
        if c.recall_every and n % c.recall_every == 0:
            shadow = shadow_recall(engine, queries, nq, k, ids)
        self._commit(engine, n, nq, k, kw, t0, e2e_ms, trace, shadow)

    def _commit(self, engine, n, nq, k, kw, t0, e2e_ms, trace, shadow):
        """Record search number ``n`` (its place in the ``queries``
        count, taken when it finished: the slow-query ring's ``seq``,
        unique under concurrent searches)."""
        c = self.config
        with self._lock:
            if c.histograms:
                self._e2e.record(e2e_ms)
                if trace:
                    for name, ms in trace["stages"]:
                        h = self._stages.get(name)
                        if h is None:
                            h = self._stages[name] = LatencyHistogram()
                        h.record(ms)
            if trace:
                self.deep_traces += 1
            if shadow is not None:
                r, kk = shadow
                a = c.recall_alpha
                self.recall_ema = (r if self.recall_ema is None
                                   else a * r + (1.0 - a) * self.recall_ema)
                self.recall_last, self.recall_k = r, kk
                self.recall_samples += 1
            slow = (c.slow_query_ms is not None
                    and e2e_ms >= c.slow_query_ms)
            if slow:
                self.slow_queries += 1
                entry = {"e2e_ms": e2e_ms, "batch": nq,
                         "bucket": engine.last_bucket, "k": k,
                         "spec": self._spec(engine),
                         "nprobe": kw.get("nprobe"),
                         "rerank": kw.get("rerank"),
                         "lut_dtype": kw.get("lut_dtype"),
                         "scan_cap": kw.get("scan_cap"),
                         "prefilter": kw.get("prefilter"),
                         "seq": n}
                if trace:
                    entry["stages"] = {s: ms for s, ms in trace["stages"]}
                self._slow.append(entry)
                if len(self._slow) > c.slow_query_capacity:
                    del self._slow[0]
            if c.trace_dir is not None and len(self._events) < c.max_events:
                ts_us = (t0 - self._origin) * 1e6
                self._events.append({
                    "name": "search", "ph": "X", "ts": ts_us,
                    "dur": e2e_ms * 1e3, "pid": os.getpid(), "tid": 1,
                    "args": {"batch": nq, "k": k,
                             "nprobe": kw.get("nprobe"),
                             "spec": self._spec(engine)}})
                if trace:
                    cursor = ts_us
                    for name, ms in trace["stages"]:
                        self._events.append({
                            "name": f"deep.{name}", "ph": "X",
                            "ts": cursor, "dur": ms * 1e3,
                            "pid": os.getpid(), "tid": 2, "args": {}})
                        cursor += ms * 1e3
        if shadow is not None and engine._policy is not None:
            engine._policy.observe_recall(*shadow)

    @staticmethod
    def _spec(engine) -> str:
        from .spec import format_spec
        return format_spec(engine.spec)

    # -- export -------------------------------------------------------------

    def metrics_sections(self):
        """(LatencyMetrics, RecallMetrics) for ``collect_metrics``: the
        ``latency.*`` / ``recall.*`` dotted sections."""
        with self._lock:
            latency = LatencyMetrics(
                search=self._e2e.snapshot(),
                stages={s: h.snapshot()
                        for s, h in sorted(self._stages.items())},
                queries=self.queries,
                slow_queries=self.slow_queries,
                slow_query_ms=self.config.slow_query_ms,
                deep_traces=self.deep_traces)
            recall = RecallMetrics(
                estimate_at_k=self.recall_ema, k=self.recall_k,
                samples=self.recall_samples, last=self.recall_last)
        return latency, recall

    def slow_query_log(self) -> list:
        """The current ring-buffer contents, oldest first (copies)."""
        with self._lock:
            return [dict(e) for e in self._slow]

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Write the buffered events as Chrome-trace JSON (open in
        ``chrome://tracing`` or Perfetto). Default path is
        ``<trace_dir>/qpad_trace_<pid>.json``; returns the path, or None
        when event capture is off. The buffer is drained."""
        with self._lock:
            if path is None:
                if self.config.trace_dir is None:
                    return None
                os.makedirs(self.config.trace_dir, exist_ok=True)
                path = os.path.join(self.config.trace_dir,
                                    f"qpad_trace_{os.getpid()}.json")
            events, self._events = self._events, []
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


@contextlib.contextmanager
def torch_profile(logdir: str):
    """Device-side profile of the enclosed block (the JAX package's
    ``jax_profile``): a ``torch.profiler`` trace of the CPU and, where a
    CUDA device is present, the CUDA activities, written on exit as
    Chrome-trace JSON to ``<logdir>/qpad_profile_<pid>.json`` (open in
    Perfetto). Yields the profiler, whose ``key_averages()`` and
    ``events()`` hold the kernel records."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"qpad_profile_{os.getpid()}.json"))


# --- program spans -----------------------------------------------------------

_profiler = torch.autograd.profiler     # its module flag is the switch
_PREFIX = "qpad."
_RECENT = 4096       # closed spans kept for inspection, newest
_PENDING = 8192      # spans awaiting their device interval: past this the
#                      oldest half is resolved (waiting on its events)
_off_seen = True     # a span site found the profiler off since the
#                      recorder's session began


@dataclasses.dataclass
class SpanStats:
    """One span name's aggregate over a profiler session: spans closed,
    their host ms, self ms (host ms less the part their children cover),
    device ms (between the CUDA events at their ends; the host interval
    on the CPU) and the counters charged to them (``host_syncs``, ...)."""
    count: int = 0
    host_ms: float = 0.0
    self_ms: float = 0.0
    device_ms: float = 0.0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def syncs(self) -> int:
        return self.counts.get("host_syncs", 0)


class Span:
    """One stage interval (a context manager from ``span``). Closed, it
    holds ``name``, ``sid``, ``parent`` (the enclosing span's ``sid`` on
    the same thread, None for a root), ``request``, ``thread``, the host
    interval ``t0`` / ``t1`` (``perf_counter`` seconds), ``child_s`` (the
    host time its children cover), ``device_ms`` (None until resolved)
    and ``counts``."""

    __slots__ = ("name", "sid", "parent", "request", "thread", "session",
                 "stream", "device", "t0", "t1", "child_s", "device_ms",
                 "counts", "_rec", "_up", "_rf", "_e0", "_e1")

    def __init__(self, rec: "SpanRecorder", name: str, device):
        self._rec, self.name, self.device = rec, name, device
        self.child_s, self.device_ms, self.counts = 0.0, None, {}

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    @property
    def self_ms(self) -> float:
        return (self.t1 - self.t0 - self.child_s) * 1e3

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = rec._stack()
        up = stack[-1] if stack else None
        self._up = up
        self.parent = None if up is None else up.sid
        self.request = (rec._new_request() if up is None else up.request)
        # the stream the span's events go on: the current one of a root's
        # CUDA device, a child's parent's; None on the CPU
        if up is not None:
            self.stream = up.stream
        elif (self.device is not None
              and torch.device(self.device).type == "cuda"):
            self.stream = torch.cuda.current_stream(self.device)
        else:
            self.stream = None
        self.sid = next(rec._sids)
        self.thread = threading.get_ident()
        self.session = rec.session
        self._rf = _profiler.record_function(_PREFIX + self.name,
                                             str(self.request))
        self._rf.__enter__()
        self._e0 = None if self.stream is None else rec._event(self.stream)
        self.t0 = time.perf_counter()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        self.t1 = time.perf_counter()
        self._e1 = None if self.stream is None else rec._event(self.stream)
        self._rf.__exit__(*exc)
        self._rf = None
        rec._stack().pop()
        if self._up is not None:
            self._up.child_s += self.t1 - self.t0
        self._up = None
        rec._close(self)
        return False


class _NoSpan:
    """What a span site gets while the profiler is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class SpanRecorder:
    """The spans and counters of the newest profiler session: per-name
    ``SpanStats`` (kept whole however many spans close), the newest
    ``_RECENT`` closed spans, and the counters made outside any span
    (under the name ``""``). Thread-safe: each thread keeps its own stack
    of open spans; closing and reading take one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._sids = itertools.count()
        self._free: Dict[torch.device, List] = {}   # events to record again
        self.session = 0
        self._begin()

    def _begin(self):
        """A new session: forget the last one's spans and counts."""
        self.session += 1
        self._stats: Dict[str, SpanStats] = {}
        self._recent = collections.deque(maxlen=_RECENT)
        self._pending = collections.deque()
        self._requests = itertools.count()

    def _current(self):
        """Start a new session when a site found the profiler off since
        this one began."""
        global _off_seen
        if _off_seen:
            with self._lock:
                if _off_seen:
                    self._begin()
                    _off_seen = False

    def open(self, name: str, device=None) -> Span:
        self._current()
        return Span(self, name, device)

    def count(self, name: str, n: int = 1):
        self._current()
        stack = self._stack()
        if stack:
            c = stack[-1].counts
            c[name] = c.get(name, 0) + n
            return
        with self._lock:
            c = self._stats.setdefault("", SpanStats()).counts
            c[name] = c.get(name, 0) + n

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new_request(self) -> int:
        with self._lock:
            return next(self._requests)

    def _event(self, stream):
        """A timing event recorded on ``stream`` (one of the pool where
        one is free)."""
        with self._lock:
            free = self._free.get(stream.device)
            ev = free.pop() if free else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _release(self, sp: Span):
        """Return a span's events to the pool (the lock held)."""
        free = self._free.setdefault(sp.stream.device, [])
        free.extend((sp._e0, sp._e1))
        sp._e0 = sp._e1 = None

    def _close(self, sp: Span):
        with self._lock:
            if sp.session != self.session:      # opened before a reset
                if sp.stream is not None:
                    self._release(sp)
                return
            st = self._stats.get(sp.name)
            if st is None:
                st = self._stats[sp.name] = SpanStats()
            st.count += 1
            st.host_ms += sp.host_ms
            st.self_ms += sp.self_ms
            for k, v in sp.counts.items():
                st.counts[k] = st.counts.get(k, 0) + v
            self._recent.append(sp)
            if sp.stream is None:
                sp.device_ms = sp.host_ms
                st.device_ms += sp.device_ms
                return
            self._pending.append(sp)
            if sp.parent is None:
                self._recycle()
            if len(self._pending) > _PENDING:
                self._resolve(len(self._pending) // 2)

    def _recycle(self):
        """Resolve the oldest pending spans whose events the card has
        passed, so their events go back to the pool while the session
        runs: one query a root, whose end event follows its children's
        on their stream. Called with the lock held."""
        pending = self._pending
        while pending:
            n = next((i for i, sp in enumerate(pending)
                      if sp.parent is None), None)
            if n is None or not pending[n]._e1.query():
                return
            stream = pending[n].stream
            if not all(sp.stream == stream or sp._e1.query()
                       for sp in itertools.islice(pending, n)):
                return
            self._resolve(n + 1, wait=False)

    def _resolve(self, n: Optional[int] = None, wait: bool = True):
        """Read the device interval of the ``n`` oldest pending spans (all
        by default), first waiting for their end events unless the card
        has passed them. Called with the lock held."""
        n = len(self._pending) if n is None else n
        for _ in range(n):
            sp = self._pending.popleft()
            if wait:
                sp._e1.synchronize()
            sp.device_ms = sp._e0.elapsed_time(sp._e1)
            self._release(sp)
            self._stats[sp.name].device_ms += sp.device_ms

    def snapshot(self) -> Dict[str, SpanStats]:
        """Per-name aggregates of the newest session, device intervals
        resolved (a copy)."""
        with self._lock:
            self._resolve()
            return {k: dataclasses.replace(v, counts=dict(v.counts))
                    for k, v in self._stats.items()}

    def recent_spans(self) -> List[Span]:
        """The newest closed spans of the session, oldest first, device
        intervals resolved."""
        with self._lock:
            self._resolve()
            return list(self._recent)


RECORDER = SpanRecorder()


def span(name: str, device=None):
    """A context manager around one stage of the path that serves. While
    no ``torch.profiler`` session records it is a shared no-op; otherwise
    a ``Span`` of ``RECORDER``. A root span (no open span on its thread)
    names the device its events go on; a child inherits its parent's."""
    global _off_seen
    if not _profiler._is_profiler_enabled:
        _off_seen = True
        return _NO_SPAN
    return RECORDER.open(name, device)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of the innermost open span (while
    a profiler session records; a no-op otherwise)."""
    if _profiler._is_profiler_enabled:
        RECORDER.count(name, n)


def snapshot() -> Dict[str, SpanStats]:
    """``RECORDER.snapshot()``: per-name ``SpanStats`` of the newest
    profiler session."""
    return RECORDER.snapshot()
