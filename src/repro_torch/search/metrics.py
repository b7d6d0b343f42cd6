"""Typed metrics: the engine's observability surface (port of
``repro.search.metrics``).

``SearchEngine.metrics()`` returns an ``EngineMetrics``: frozen
dataclasses of named counters and gauges with *stable dotted names*
(``wal.records``, ``stream.fill``, ``compact.pending``,
``policy.drift_ema``, ``replication.follower_lag_seq``, ...), the JAX
package's names. Dashboards and the ``--metrics-port`` endpoint key off
them, so they only ever gain entries.

When the engine has a ``Tracer`` attached (``engine.tracing()``, see
``repro_torch.search.tracing``) two more sections appear: ``latency.*``,
end-to-end and per-stage histograms (``HistogramSnapshot``) flattened to
``.p50/.p95/.p99/.count/.sum_ms`` plus slow-query counters, and
``recall.*``, the shadow-exact online recall estimate.

Renderings:

- ``EngineMetrics.flatten()``: ``{dotted_name: value}`` for JSON.
- ``render_prometheus(m)``: Prometheus text exposition (dots become
  underscores under a ``qpad_`` prefix, names sanitized to the
  Prometheus grammar; counters and gauges get TYPE lines;
  ``HistogramSnapshot`` sections render as real ``histogram`` series
  in seconds with cumulative ``_bucket``/``_sum``/``_count``;
  string-valued entries ride on a ``qpad_engine_info`` label set with
  escaped values). For equal values the text is the JAX package's, byte
  for byte.
- ``MetricsServer``: a stdlib ``http.server`` thread serving both
  (``/metrics`` Prometheus text, ``/metrics.json`` JSON); the
  launcher's ``--metrics-port`` flag.
"""
from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
from typing import Mapping, Optional, Tuple

__all__ = ["EngineInfo", "StreamMetrics", "CompactMetrics", "PolicyMetrics",
           "WalMetrics", "SnapshotMetrics", "ReplicationMetrics",
           "HistogramSnapshot", "LatencyMetrics", "RecallMetrics",
           "EngineMetrics", "collect_metrics", "render_prometheus",
           "MetricsServer"]


@dataclasses.dataclass(frozen=True)
class HistogramSnapshot:
    """A frozen latency histogram: ``counts[i]`` observations at most
    ``bounds_ms[i]`` milliseconds (trailing overflow bucket), plus the
    exact sum/count. Percentiles interpolate linearly inside the winning
    bucket — the usual fixed-boundary estimate, so their resolution is
    the bucket width (log-spaced: ~a factor of 2)."""
    bounds_ms: Tuple[float, ...]
    counts: Tuple[int, ...]          # len(bounds_ms) + 1 (overflow)
    sum_ms: float
    count: int

    def percentile(self, p: float) -> float:
        """p in [0, 100] -> estimated latency in ms (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        target = (p / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds_ms[i - 1] if i > 0 else 0.0
                hi = (self.bounds_ms[i] if i < len(self.bounds_ms)
                      else self.bounds_ms[-1] * 2.0)
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.bounds_ms[-1] * 2.0


@dataclasses.dataclass(frozen=True)
class LatencyMetrics:
    """Request-latency section (present when a ``Tracer`` is attached)."""
    search: HistogramSnapshot        # latency.search.{p50,p95,p99,...}
    stages: Mapping[str, HistogramSnapshot]  # latency.stages.<stage>.*
    #                                  (deep-trace samples only)
    queries: int                     # latency.queries (traced searches)
    slow_queries: int                # latency.slow_queries
    slow_query_ms: Optional[float]   # latency.slow_query_ms (threshold)
    deep_traces: int                 # latency.deep_traces


@dataclasses.dataclass(frozen=True)
class RecallMetrics:
    """Online recall estimation (shadow-exact sampling)."""
    estimate_at_k: Optional[float]   # recall.estimate_at_k (EMA gauge)
    k: Optional[int]                 # recall.k (effective k of the checks)
    samples: int                     # recall.samples
    last: Optional[float]            # recall.last (newest raw sample)


@dataclasses.dataclass(frozen=True)
class EngineInfo:
    """Identity gauges: what this engine is."""
    index: str                       # engine.index
    spec: str                        # engine.spec
    streaming: bool                  # engine.streaming
    sharded: bool                    # engine.sharded
    role: str                        # engine.role ("primary" | "follower")
    compile_count: int               # engine.compile_count


@dataclasses.dataclass(frozen=True)
class StreamMetrics:
    """StreamStore occupancy gauges."""
    rows: int                        # stream.rows (allocated base rows;
    #                                  live = rows - tombstones)
    row_capacity: int                # stream.row_capacity
    delta_used: int                  # stream.delta_used
    delta_count: int                 # stream.delta_count
    delta_capacity: int              # stream.delta_capacity
    fill: float                      # stream.fill (delta_used / capacity)
    tombstones: int                  # stream.tombstones
    grow_count: int                  # stream.grow_count


@dataclasses.dataclass(frozen=True)
class CompactMetrics:
    """Compaction / maintenance counters + the in-flight gauge."""
    pending: bool                    # compact.pending (background fold live)
    compactions: int                 # compact.compactions
    swaps: int                       # compact.swaps
    vacuums: int                     # compact.vacuums
    rebuilds: int                    # compact.rebuilds
    policy_grows: int                # compact.policy_grows


@dataclasses.dataclass(frozen=True)
class PolicyMetrics:
    """MaintenancePolicy drift tracker + decision counters."""
    drift_ema: Optional[float]       # policy.drift_ema (recent build error)
    drift_base: Optional[float]      # policy.drift_base (error at build)
    drift_ratio: Optional[float]     # policy.drift_ratio (recent / base)
    observed_rows: int               # policy.observed_rows
    decisions: Mapping[str, int]     # policy.decisions.<kind>


@dataclasses.dataclass(frozen=True)
class WalMetrics:
    """Write-ahead-log counters and positions."""
    records: int                     # wal.records
    bytes: int                       # wal.bytes
    fsyncs: int                      # wal.fsyncs
    rotations: int                   # wal.rotations
    group_commits: int               # wal.group_commits
    segments: int                    # wal.segments
    last_seq: int                    # wal.last_seq
    durable_seq: int                 # wal.durable_seq
    floor_seq: int                   # wal.floor_seq (truncation pin; -1=none)
    replayed: int                    # wal.replayed (records at last recovery)
    fsync: str                       # wal.fsync (mode string)
    group_commit_ms: float           # wal.group_commit_ms


@dataclasses.dataclass(frozen=True)
class SnapshotMetrics:
    """Snapshot persistence counters (``engine.save``)."""
    full: int                        # snapshot.full
    incremental: int                 # snapshot.incremental
    last_bytes: int                  # snapshot.last_bytes (newest ckpt)
    chain_depth: int                 # snapshot.chain_depth (incrementals
    #                                  stacked on the current base)


@dataclasses.dataclass(frozen=True)
class ReplicationMetrics:
    """Follower position relative to its source (``catch_up``)."""
    applied_seq: int                 # replication.applied_seq
    source_tail_seq: int             # replication.source_tail_seq
    follower_lag_seq: int            # replication.follower_lag_seq
    catch_ups: int                   # replication.catch_ups
    records_applied: int             # replication.records_applied
    lag_seconds: Optional[float]     # replication.lag_seconds: wall time
    #                                  since the follower last drained its
    #                                  source (None until it first does)
    catch_up_age_seconds: Optional[float]  # replication.catch_up_age_seconds:
    #                                  wall time since the last catch_up
    #                                  pass of any kind (staleness alarm)


@dataclasses.dataclass(frozen=True)
class EngineMetrics:
    """One engine's full metrics snapshot. Sections that do not apply
    (a read-only engine has no ``stream``; a primary has no
    ``replication``) are ``None`` and drop out of ``flatten()``."""
    engine: EngineInfo
    stream: Optional[StreamMetrics] = None
    compact: Optional[CompactMetrics] = None
    policy: Optional[PolicyMetrics] = None
    wal: Optional[WalMetrics] = None
    snapshot: Optional[SnapshotMetrics] = None
    replication: Optional[ReplicationMetrics] = None
    latency: Optional[LatencyMetrics] = None
    recall: Optional[RecallMetrics] = None

    def flatten(self) -> dict:
        """``{dotted_name: value}`` — the stable wire form. Histogram
        fields flatten to derived ``.p50/.p95/.p99/.count/.sum_ms``
        entries (``latency.search.p50``, ``latency.stages.scan.p99``,
        ...); the full bucket vectors stay behind ``histograms()``."""
        out = {}
        for section in dataclasses.fields(self):
            val = getattr(self, section.name)
            if val is None:
                continue
            for f in dataclasses.fields(val):
                v = getattr(val, f.name)
                name = f"{section.name}.{f.name}"
                if isinstance(v, HistogramSnapshot):
                    out.update(_hist_entries(name, v))
                elif isinstance(v, Mapping):
                    for k in sorted(v):
                        if isinstance(v[k], HistogramSnapshot):
                            out.update(_hist_entries(f"{name}.{k}", v[k]))
                        else:
                            out[f"{name}.{k}"] = v[k]
                else:
                    out[name] = v
        return out

    def histograms(self) -> dict:
        """``{dotted_name: HistogramSnapshot}`` — the sections that
        render as Prometheus ``histogram`` series."""
        out = {}
        for section in dataclasses.fields(self):
            val = getattr(self, section.name)
            if val is None:
                continue
            for f in dataclasses.fields(val):
                v = getattr(val, f.name)
                name = f"{section.name}.{f.name}"
                if isinstance(v, HistogramSnapshot):
                    out[name] = v
                elif isinstance(v, Mapping):
                    for k in sorted(v):
                        if isinstance(v[k], HistogramSnapshot):
                            out[f"{name}.{k}"] = v[k]
        return out

    def to_json(self) -> str:
        return json.dumps(self.flatten(), sort_keys=True)


def _hist_entries(name: str, h: HistogramSnapshot) -> dict:
    return {f"{name}.p50": h.percentile(50.0),
            f"{name}.p95": h.percentile(95.0),
            f"{name}.p99": h.percentile(99.0),
            f"{name}.count": h.count,
            f"{name}.sum_ms": h.sum_ms}


# Dotted names that are monotonically increasing counters; everything
# else numeric is a gauge. Prefix-matched for the decision counters.
_COUNTER_NAMES = frozenset((
    "engine.compile_count", "stream.grow_count",
    "compact.compactions", "compact.swaps", "compact.vacuums",
    "compact.rebuilds", "compact.policy_grows",
    "wal.records", "wal.bytes", "wal.fsyncs", "wal.rotations",
    "wal.group_commits", "wal.replayed",
    "snapshot.full", "snapshot.incremental",
    "replication.catch_ups", "replication.records_applied",
    "latency.queries", "latency.slow_queries", "latency.deep_traces",
    "recall.samples",
))


def _is_counter(name: str) -> bool:
    return name in _COUNTER_NAMES or name.startswith("policy.decisions.")


def _sanitize_name(name: str) -> str:
    """Dotted metric name -> valid Prometheus identifier
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``). Spec-derived map keys can carry
    digits/hyphens/arbitrary punctuation — every invalid byte becomes
    ``_`` and a leading digit gets a ``_`` prefix."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote and
    newline (spec strings contain ``>``/``:`` which are legal, but a
    quote or newline would tear the exposition)."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_histogram(lines: list, name: str, h: HistogramSnapshot):
    """One Prometheus ``histogram`` series (in seconds, the Prometheus
    base unit) with cumulative ``_bucket`` counts, ``_sum``, ``_count``."""
    pname = _sanitize_name("qpad_" + name.replace(".", "_") + "_seconds")
    lines.append(f"# TYPE {pname} histogram")
    cum = 0
    for bound_ms, count in zip(h.bounds_ms, h.counts):
        cum += count
        lines.append(f'{pname}_bucket{{le="{bound_ms / 1e3:.6g}"}} {cum}')
    cum += h.counts[-1]
    lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
    lines.append(f"{pname}_sum {h.sum_ms / 1e3:.9g}")
    lines.append(f"{pname}_count {h.count}")


def render_prometheus(m: EngineMetrics) -> str:
    """Prometheus text exposition of one metrics snapshot. Numeric
    entries become ``qpad_<dotted_with_underscores>`` samples with TYPE
    lines (names sanitized to the Prometheus grammar); histogram
    sections become real ``histogram`` series in seconds
    (``qpad_latency_search_seconds_bucket``/``_sum``/``_count``)
    alongside the derived percentile gauges; string entries (index kind,
    fsync mode, role, spec) become escaped labels on a single
    ``qpad_engine_info`` gauge."""
    lines, info_labels = [], []
    for name, value in sorted(m.flatten().items()):
        if value is None:
            continue
        if isinstance(value, str):
            key = _sanitize_name(name.replace(".", "_"))
            info_labels.append(f'{key}="{_escape_label(value)}"')
            continue
        pname = _sanitize_name("qpad_" + name.replace(".", "_"))
        kind = "counter" if _is_counter(name) else "gauge"
        lines.append(f"# TYPE {pname} {kind}")
        if isinstance(value, bool):
            value = int(value)
        lines.append(f"{pname} {value}")
    for name, h in sorted(m.histograms().items()):
        _render_histogram(lines, name, h)
    lines.append("# TYPE qpad_engine_info gauge")
    lines.append("qpad_engine_info{%s} 1" % ",".join(info_labels))
    return "\n".join(lines) + "\n"


def collect_metrics(engine) -> EngineMetrics:
    """Assemble ``EngineMetrics`` from a live ``SearchEngine``. On a
    streaming engine ``stream.tombstones`` is one reduction of the
    tombstone bitmap read back to the host: one device sync a scrape,
    queued on the caller's stream behind the searches already issued."""
    from .spec import format_spec

    info = EngineInfo(
        index=engine.config.index, spec=format_spec(engine.spec),
        streaming=engine.store is not None,
        sharded=(engine.sharded_state is not None
                 or engine._stream_sharded_base is not None),
        role=engine._role, compile_count=engine.compile_count)
    stream = compact = policy = wal = snapshot = replication = None
    store = engine.store
    if store is not None:
        cap = int(store.delta_ids.shape[0])
        used = engine._delta_used
        tombstones = int(store.dead.sum())
        stream = StreamMetrics(
            rows=int(store.n_rows),
            row_capacity=int(store.corpus.shape[0]),
            delta_used=used, delta_count=int(store.delta_count),
            delta_capacity=cap, fill=used / cap if cap else 0.0,
            tombstones=tombstones,
            grow_count=engine.grow_count)
        c = engine.counters
        compact = CompactMetrics(
            pending=engine._compact_future is not None,
            compactions=c["compactions"], swaps=c["swaps"],
            vacuums=c["vacuums"], rebuilds=c["rebuilds"],
            policy_grows=c["policy_grows"])
        sc = engine._snap_counters
        snapshot = SnapshotMetrics(
            full=sc["full"], incremental=sc["incremental"],
            last_bytes=sc["last_bytes"], chain_depth=sc["chain_depth"])
    if engine._policy is not None:
        ps = engine._policy.stats()
        policy = PolicyMetrics(
            drift_ema=ps["recent_error"], drift_base=ps["base_error"],
            drift_ratio=ps["drift_ratio"], observed_rows=ps["recent_rows"],
            decisions=dict(ps["decisions"]))
    if engine._wal is not None:
        ws = engine._wal.stats()
        wal = WalMetrics(
            records=ws["records"], bytes=ws["bytes"], fsyncs=ws["fsyncs"],
            rotations=ws["rotations"], group_commits=ws["group_commits"],
            segments=ws["segments"], last_seq=ws["last_seq"],
            durable_seq=ws["durable_seq"], floor_seq=ws["floor_seq"],
            replayed=engine._replayed, fsync=ws["fsync"],
            group_commit_ms=ws["group_commit_ms"])
    if engine._role == "follower":
        now = time.time()
        last_ts = getattr(engine, "_repl_last_catch_up_ts", None)
        caught_ts = getattr(engine, "_repl_caught_up_ts", None)
        replication = ReplicationMetrics(
            applied_seq=engine._applied_seq,
            source_tail_seq=engine._repl_source_tail,
            follower_lag_seq=max(
                0, engine._repl_source_tail - engine._applied_seq),
            catch_ups=engine._repl_catch_ups,
            records_applied=engine._repl_records,
            lag_seconds=(None if caught_ts is None else now - caught_ts),
            catch_up_age_seconds=(None if last_ts is None
                                  else now - last_ts))
    latency = recall = None
    tracer = engine.tracer
    if tracer is not None:
        latency, recall = tracer.metrics_sections()
    return EngineMetrics(engine=info, stream=stream, compact=compact,
                         policy=policy, wal=wal, snapshot=snapshot,
                         replication=replication, latency=latency,
                         recall=recall)


class MetricsServer:
    """Serve an engine's metrics from a background ``http.server``
    thread — the launcher's ``--metrics-port``.

    Routes: ``/metrics`` (Prometheus text), ``/metrics.json`` and ``/``
    (flattened JSON). Each request takes a fresh ``metrics()`` snapshot;
    a scrape that races an engine mutation gets a 503 and retries on the
    next interval. ``port=0`` binds an ephemeral port (``.port`` has the
    real one). Context-manager friendly; ``close()`` stops the thread.
    """

    def __init__(self, engine, port: int = 0, host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(handler):
                try:
                    m = engine.metrics()
                    if handler.path == "/metrics":
                        body = render_prometheus(m).encode()
                        ctype = "text/plain; version=0.0.4"
                    elif handler.path in ("/", "/metrics.json"):
                        body = m.to_json().encode()
                        ctype = "application/json"
                    else:
                        handler.send_error(404)
                        return
                except Exception as e:       # raced an engine mutation
                    handler.send_error(503, explain=str(e))
                    return
                handler.send_response(200)
                handler.send_header("Content-Type", ctype)
                handler.send_header("Content-Length", str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)

            def log_message(handler, *a):    # quiet: no per-scrape stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="qpad-metrics",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
