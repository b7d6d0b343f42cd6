"""Port parity for the typed metrics surface (repro_torch.search.metrics):
twins of tests/test_metrics.py, and the renderings held against the JAX
package's.

* the dotted names, the sections that apply and those that drop out, the
  renderings (Prometheus text with TYPE lines, histograms, sanitized
  names, escaped labels), the exposition lint over every index kind, and
  ``MetricsServer`` under concurrent scrapes mid-traffic;
* ``render_prometheus`` byte-equal to JAX's for equal values: from one set
  of numbers in every section, and from a JAX streaming engine and the
  port's engine over the same store (``bridge.stream_from_arrays``) after
  the same writes; ``flatten()`` with JAX's keys;
* ``compile_count`` equal to JAX's after every operation of one sequence
  through a JAX engine and a port engine carried across from it.

The port runs on the CPU (``device="cpu"``), its kernels' plain versions.
JAX is imported inside the tests (this file holds ``gpu`` tests, run on
the card where JAX is absent).
"""
import dataclasses
import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.bridge import (state_from_arrays,  # noqa: E402
                                stream_from_arrays)
from repro_torch.search import (DurabilityConfig, MetricsServer,  # noqa: E402
                                PolicyConfig, SearchEngine, ServeConfig,
                                StreamConfig, build_engine, config_from_spec,
                                render_prometheus, seed_follower)
from repro_torch.search import metrics as tmetrics  # noqa: E402
from repro_torch.search.metrics import (_escape_label,  # noqa: E402
                                        _sanitize_name)

N, DIM, K = 600, 32, 10


def _data(seed=0, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2
    lab = rng.integers(0, 12, n)
    return (centers[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _stream_cfg(**stream_kw):
    stream_kw.setdefault("delta_capacity", 64)
    return ServeConfig(index="flat", rerank=128, fit_sample=512,
                       stream=StreamConfig(**stream_kw))


def _engine(cfg):
    return SearchEngine(_data(), cfg, device="cpu")


def _rows(seed, n):
    return _data(seed=seed, n=n)


def _jax():
    jax = pytest.importorskip("jax")
    return jax


# --- twins of tests/test_metrics.py ------------------------------------------

def test_typed_surface_dotted_names():
    """The documented dotted names are present with live values; the
    sections that do not apply are None and absent from flatten()."""
    eng = _engine(_stream_cfg())
    eng.upsert(np.arange(600, 620), _rows(1, 20))
    m = eng.metrics()
    flat = m.flatten()
    assert flat["engine.index"] == "flat"
    assert flat["engine.streaming"] is True
    assert flat["engine.sharded"] is False
    assert flat["engine.role"] == "primary"
    assert flat["engine.compile_count"] == eng.compile_count == 1
    assert flat["stream.delta_used"] == 20
    assert flat["stream.fill"] == pytest.approx(20 / 64)
    assert flat["compact.pending"] is False
    assert m.wal is None and m.replication is None
    assert m.latency is None and m.recall is None  # no tracer attached
    assert not any(k.startswith(("wal.", "replication.", "latency.",
                                 "recall.")) for k in flat)
    ro = _engine(ServeConfig(index="flat")).metrics()
    assert ro.stream is None and ro.compact is None and ro.snapshot is None
    assert ro.engine.streaming is False


def test_typed_surface_wal_policy_and_follower_sections(tmp_path):
    """Durable engines expose wal.* (fsyncs, floor), policy engines
    policy.* (drift + decision counters), followers replication.*."""
    live = str(tmp_path / "live")
    eng = _engine(_stream_cfg(policy=PolicyConfig())).durable(
        live, DurabilityConfig(fsync="batch"))
    eng.upsert(np.arange(600, 620), _rows(1, 20))
    flat = eng.metrics().flatten()
    assert flat["wal.records"] >= 2            # snapshot mark + upsert
    assert flat["wal.fsyncs"] >= 1
    assert flat["wal.durable_seq"] <= flat["wal.last_seq"]
    assert flat["wal.floor_seq"] == 0          # pinned by the base snapshot
    assert flat["wal.fsync"] == "batch"
    assert flat["policy.observed_rows"] == 0
    assert "policy.drift_ema" in flat
    assert flat["snapshot.full"] == 1
    eng._wal.sync()
    fol = seed_follower(live, device="cpu")
    ff = fol.metrics().flatten()
    assert ff["engine.role"] == "follower"
    assert ff["replication.follower_lag_seq"] >= 0
    assert "wal.records" not in ff             # followers own no log
    eng.close()


def test_stats_removed():
    """The typed surface is the only counters window: no dict view."""
    eng = _engine(_stream_cfg())
    assert not hasattr(eng, "stats")
    assert not hasattr(SearchEngine, "stats")
    assert eng.metrics().engine.streaming is True


def test_latency_section_and_histogram_rendering():
    """A traced engine grows latency.* names in flatten() and a proper
    Prometheus histogram (_bucket/_sum/_count) in the text form."""
    eng = _engine(ServeConfig(index="flat")).tracing()
    q = _rows(3, 8)
    for _ in range(5):
        eng.search(q, K)
    flat = eng.metrics().flatten()
    assert flat["latency.queries"] == 5
    for p in ("p50", "p95", "p99"):
        assert flat[f"latency.search.{p}"] > 0.0
    assert flat["latency.search.p50"] <= flat["latency.search.p99"]
    assert flat["latency.search.count"] == 5
    assert flat["latency.search.sum_ms"] > 0.0
    text = render_prometheus(eng.metrics())
    assert "# TYPE qpad_latency_search_seconds histogram" in text
    buckets = [int(m.group(1)) for m in re.finditer(
        r'qpad_latency_search_seconds_bucket\{le="[^"]+"\} (\d+)', text)]
    assert buckets == sorted(buckets)          # cumulative
    assert buckets[-1] == 5                    # +Inf holds every sample
    assert "qpad_latency_search_seconds_count 5" in text
    assert "qpad_latency_search_seconds_sum " in text


def test_recall_section_and_slow_query_capture():
    """Shadow-exact sampling feeds recall.estimate_at_k; a zero slow
    threshold captures every query into the ring with its knobs."""
    eng = build_engine(_data(), "ivf12x4>pq8x64>rr40", device="cpu").tracing(
        recall_every=1, slow_query_ms=0.0, deep_trace_every=2)
    q = _rows(3, 8)
    for _ in range(4):
        eng.search(q, K)
    m = eng.metrics()
    assert m.recall.samples == 4
    assert 0.0 < m.recall.estimate_at_k <= 1.0
    assert m.recall.k == K
    assert m.latency.slow_queries == 4
    assert m.latency.deep_traces == 2          # sampled 1-in-2
    assert set(m.latency.stages) >= {"project", "probe", "scan", "rerank"}
    ring = eng.tracer.slow_query_log()
    assert len(ring) == 4
    assert ring[-1]["k"] == K and ring[-1]["batch"] == 8
    assert ring[-1]["e2e_ms"] > 0.0
    text = render_prometheus(m)
    assert "qpad_recall_estimate_at_k" in text
    assert "# TYPE qpad_recall_estimate_at_k gauge" in text


def test_render_prometheus_text():
    eng = _engine(_stream_cfg())
    eng.upsert(np.arange(600, 610), _rows(1, 10))
    text = render_prometheus(eng.metrics())
    assert "# TYPE qpad_engine_compile_count counter" in text
    assert "# TYPE qpad_stream_fill gauge" in text
    assert "qpad_stream_delta_used 10" in text
    assert "qpad_compact_pending 0" in text    # bools render as 0/1
    assert 'engine_index="flat"' in text
    assert text.rstrip().splitlines()[-1].startswith("qpad_engine_info{")


def test_name_sanitization_and_label_escaping():
    """Dotted names with hostile characters become valid Prometheus
    names; label values with quotes/backslashes/newlines stay one
    well-formed line; both helpers agree with JAX's on every input."""
    from repro.search import metrics as jmetrics
    assert _sanitize_name("latency.search.p50") == "latency_search_p50"
    assert _sanitize_name("qpad.per-stage/scan") == "qpad_per_stage_scan"
    assert _sanitize_name("0weird") == "_0weird"
    assert _sanitize_name("ok_name:sub") == "ok_name:sub"
    assert _escape_label('a"b') == 'a\\"b'
    assert _escape_label("a\\b") == "a\\\\b"
    assert _escape_label("a\nb") == "a\\nb"
    for s in ("latency.search.p50", "0weird", "a-b/c d:e", "", "é.x",
              'a"b\\c\nd', "qpad64>ivf1024x16>pq16x256:i8@kernel>rr64"):
        assert _sanitize_name(s) == jmetrics._sanitize_name(s)
        assert _escape_label(s) == jmetrics._escape_label(s)
    text = render_prometheus(_engine(ServeConfig(index="flat")).metrics())
    info = [ln for ln in text.splitlines()
            if ln.startswith("qpad_engine_info{")]
    assert len(info) == 1 and "\n" not in info[0]


# --- exposition lint (tests/test_metrics.py's) -------------------------------

_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})? '
    r'-?(\d+\.?\d*([eE][+-]?\d+)?|[+-]?Inf|NaN)$')


def _lint_exposition(text):
    """Minimal Prometheus text-format checker: every line is a comment or
    a well-formed sample; TYPE precedes its samples; each histogram's
    buckets are cumulative, end at +Inf, and agree with _count; no
    duplicate sample names outside histogram series."""
    typed, seen = {}, set()
    hist = {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ")
            assert name not in typed, f"duplicate TYPE for {name}"
            assert kind in ("counter", "gauge", "histogram"), ln
            typed[name] = kind
            continue
        if ln.startswith("#"):
            continue
        assert _SAMPLE_RE.match(ln), f"malformed sample line: {ln!r}"
        name = re.split(r"[{ ]", ln, maxsplit=1)[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if typed.get(base) == "histogram":
            series = hist.setdefault(base, {"buckets": [], "count": None})
            val = float(ln.rsplit(" ", 1)[1])
            if name.endswith("_bucket"):
                le = re.search(r'le="([^"]+)"', ln).group(1)
                series["buckets"].append((le, val))
            elif name.endswith("_count"):
                series["count"] = val
        else:
            assert typed.get(name), f"sample before TYPE: {ln!r}"
            key = ln.rsplit(" ", 1)[0]
            assert key not in seen, f"duplicate sample: {key!r}"
            seen.add(key)
    for base, series in hist.items():
        counts = [v for _, v in series["buckets"]]
        assert counts == sorted(counts), f"{base} buckets not cumulative"
        assert series["buckets"][-1][0] == "+Inf", f"{base} missing +Inf"
        assert counts[-1] == series["count"], f"{base} +Inf != _count"
    return typed


@pytest.mark.parametrize("spec", ("flat", "ivf12x4", "pq8x64", "opq8x64",
                                  "ivf12x4>pq8x64>rr40"))
def test_exposition_lint_every_index_kind(spec):
    """The /metrics text of every index kind, traced so the histogram
    series render too, passes the exposition lint."""
    eng = build_engine(_data(), spec, device="cpu").tracing(recall_every=2)
    q = _rows(3, 8)
    for _ in range(3):
        eng.search(q, K)
    typed = _lint_exposition(render_prometheus(eng.metrics()))
    assert typed.get("qpad_latency_search_seconds") == "histogram"
    assert typed.get("qpad_engine_compile_count") == "counter"


def test_metrics_server_serves_both_forms(tmp_path):
    """The --metrics-port endpoint: Prometheus text at /metrics, the
    flattened JSON at /metrics.json, 404 elsewhere."""
    eng = _engine(_stream_cfg()).durable(
        str(tmp_path / "live"), DurabilityConfig(fsync="batch"))
    eng.upsert(np.arange(600, 620), _rows(1, 20))
    with MetricsServer(eng, port=0) as srv:
        assert srv.port > 0
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            body = r.read().decode()
        assert "qpad_wal_records" in body
        assert "# TYPE qpad_wal_fsyncs counter" in body
        base = f"http://{srv.host}:{srv.port}"
        with urllib.request.urlopen(base + "/metrics.json",
                                    timeout=10) as r:
            doc = json.loads(r.read().decode())
        assert doc["stream.delta_used"] == 20
        assert doc["wal.records"] >= 2
        assert doc["engine.role"] == "primary"
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert exc.value.code == 404
    eng.close()


def test_metrics_server_concurrent_scrapes_mid_traffic():
    """Scrapes racing live writes and traced searches: every response is
    a 200 that passes the exposition lint."""
    eng = _engine(_stream_cfg(delta_capacity=256)).tracing(slow_query_ms=0.0)
    q = _rows(3, 8)
    eng.search(q, K)
    errors = []

    def scraper(url, n):
        try:
            for _ in range(n):
                with urllib.request.urlopen(url, timeout=10) as r:
                    assert r.status == 200
                    _lint_exposition(r.read().decode())
        except Exception as e:                 # surfaced below
            errors.append(e)

    with MetricsServer(eng, port=0) as srv:
        ths = [threading.Thread(target=scraper, args=(srv.url, 8))
               for _ in range(4)]
        for t in ths:
            t.start()
        for i in range(6):                     # traffic while they scrape
            eng.upsert(np.arange(600 + 8 * i, 608 + 8 * i), _rows(4 + i, 8))
            eng.search(q, K)
        for t in ths:
            t.join()
    assert not errors
    m = eng.metrics()
    assert m.latency.queries == 7              # warmup + 6 in-loop
    assert m.stream.delta_used == 48


# --- the renderings against JAX's --------------------------------------------

def _sections(mod, hist_counts):
    """One set of numbers in every section, as ``mod``'s dataclasses."""
    bounds = tuple(0.05 * 2.0 ** i for i in range(22))

    def hist(counts, sum_ms):
        return mod.HistogramSnapshot(bounds_ms=bounds, counts=tuple(counts),
                                     sum_ms=sum_ms, count=sum(counts))
    h1 = hist(hist_counts, 12.345678901234)
    h2 = hist([0] * 5 + [3, 1] + [0] * 15 + [1], 1e-7)
    return mod.EngineMetrics(
        engine=mod.EngineInfo(index="ivfpq", spec='qpad8>ivf"12x4\\>rr40',
                              streaming=True, sharded=False, role="follower",
                              compile_count=7),
        stream=mod.StreamMetrics(rows=1234, row_capacity=4096,
                                 delta_used=33, delta_count=30,
                                 delta_capacity=64, fill=33 / 64,
                                 tombstones=5, grow_count=2),
        compact=mod.CompactMetrics(pending=True, compactions=4, swaps=4,
                                   vacuums=1, rebuilds=0, policy_grows=1),
        policy=mod.PolicyMetrics(drift_ema=0.1 + 0.2, drift_base=1 / 3,
                                 drift_ratio=None, observed_rows=17,
                                 decisions={"grow": 1, "vacuum-x": 2,
                                            "0rebuild": 0}),
        wal=mod.WalMetrics(records=99, bytes=123456789, fsyncs=12,
                           rotations=1, group_commits=3, segments=2,
                           last_seq=98, durable_seq=97, floor_seq=-1,
                           replayed=0, fsync="always\nbatch",
                           group_commit_ms=2.5),
        snapshot=mod.SnapshotMetrics(full=1, incremental=2,
                                     last_bytes=6881234, chain_depth=2),
        replication=mod.ReplicationMetrics(
            applied_seq=60, source_tail_seq=77, follower_lag_seq=17,
            catch_ups=3, records_applied=61, lag_seconds=1e-5,
            catch_up_age_seconds=12345.678),
        latency=mod.LatencyMetrics(search=h1, stages={"scan": h2,
                                                      "project": h1},
                                   queries=41, slow_queries=3,
                                   slow_query_ms=0.0, deep_traces=11),
        recall=mod.RecallMetrics(estimate_at_k=0.9512000000000001, k=10,
                                 samples=4, last=1.0))


@pytest.mark.parametrize("counts", [
    [0] * 23,
    [1] * 23,
    [0, 0, 7, 19, 3, 0, 0, 1] + [0] * 15,
])
def test_render_prometheus_is_jax_text_for_equal_values(counts):
    from repro.search import metrics as jmetrics
    jm, tm = _sections(jmetrics, counts), _sections(tmetrics, counts)
    assert tm.flatten() == jm.flatten()
    assert list(tm.flatten()) == list(jm.flatten())
    assert tm.to_json() == jm.to_json()
    assert sorted(tm.histograms()) == sorted(jm.histograms())
    text = tmetrics.render_prometheus(tm)
    assert text.encode() == jmetrics.render_prometheus(jm).encode()
    _lint_exposition(text)


def _jax_store_arrays(store, frozen):
    jax = _jax()
    flat, _ = jax.tree_util.tree_flatten_with_path(
        {"store": store, "frozen": frozen})
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _state_arrays(state):
    jax = _jax()
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.mark.parametrize("spec", ["flat", "ivf12x4>pq8x64:i8>rr64",
                                  "pq8x64>rr64"])
def test_bridged_streaming_engine_renders_jax_text(spec):
    """A JAX streaming engine and the port's engine over the same store,
    after the same writes (upserts, deletes, a compaction, a grow): equal
    flatten() keys and values, and the Prometheus text byte for byte."""
    from repro.search import StreamConfig as JStreamConfig
    from repro.search import build_engine as jax_build_engine
    from repro.search import render_prometheus as jax_render
    scfg = dict(delta_capacity=32, write_bucket=16, row_capacity=N + 48,
                cell_slack=4)
    jeng = jax_build_engine(_data(), spec, fit_sample=512,
                            stream=JStreamConfig(**scfg))
    ts, tf = stream_from_arrays(_jax_store_arrays(jeng.store, jeng.frozen),
                                spec, device="cpu")
    teng = SearchEngine.from_store(ts, tf, config_from_spec(
        spec, fit_sample=512, stream=StreamConfig(**scfg)))
    q = _rows(3, 8)
    for i in range(5):
        for e in (jeng, teng):
            e.upsert(np.arange(600 + 20 * i, 620 + 20 * i), _rows(10 + i, 20))
            e.delete(np.arange(3 * i, 3 * i + 3))
            e.search(q, K)
    for e in (jeng, teng):
        e.compact()
        e.upsert(np.arange(900, 910), _rows(30, 10))
    assert teng.grow_count == jeng.grow_count >= 1
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm.flatten() == jm.flatten()
    assert list(tm.flatten()) == list(jm.flatten())
    assert render_prometheus(tm).encode() == jax_render(jm).encode()


def test_read_only_engine_renders_jax_text():
    from repro.search import build_engine as jax_build_engine
    from repro.search import render_prometheus as jax_render
    spec = "ivf12x4>pq8x64>rr40"
    jeng = jax_build_engine(_data(), spec)
    teng = SearchEngine.from_state(
        state_from_arrays(_state_arrays(jeng.state), spec, device="cpu"),
        config_from_spec(spec))
    q = _rows(3, 64)
    for nq in (1, 8, 64):
        jeng.search(q[:nq], K)
        teng.search(q[:nq], K)
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm.flatten() == jm.flatten()
    assert render_prometheus(tm).encode() == jax_render(jm).encode()


# --- compile_count against JAX's ---------------------------------------------

def _search(nq, k=K):
    return ("search", nq, k)


# (name, spec, runtime knobs, streaming config or None, operations)
# tests/test_serve_fused.py's buckets, k and small batches; the knob and
# LUT changes that re-key the programs; tests/test_snapshot.py's restored
# engine; tests/test_stream.py's zero-recompile pin and shared write
# buckets; a grow; vacuum; a quantizer rebuild; tests/test_tracing.py's
# traced engine (deep traces and shadow checks never count).
_SEQUENCES = [
    ("fused-buckets", "ivf12x4>pq8x64>rr40", {}, None, [
        _search(9), _search(33), _search(64), _search(14, 5), _search(1),
        _search(3), _search(8), _search(70), ("cfg", dict(nprobe=6)),
        _search(64), ("cfg", dict(lut_dtype="int8")), _search(64),
        _search(1), ("cfg", dict(small_batch=0, query_bucket=8)),
        _search(3), _search(9), _search(16)]),
    ("prefilter", "ivf12x4>pq8x64>rr40", {"prefilter_batch": 64}, None, [
        _search(1), _search(8), _search(64), _search(128), _search(8, 5)]),
    ("flat-knobs", "flat", {}, None, [
        _search(8), _search(8), _search(8, 5), ("save-load",), _search(8),
        _search(8), _search(8, 5)]),
    ("restored", "qpad8>ivf12x5>pq8x64:i8>rr64", {}, None, [
        _search(16), ("save-load",), _search(16), _search(16), _search(16)]),
    ("traced", "ivf12x4>pq8x64>rr40", {}, None, [
        _search(8), ("trace",), _search(8), _search(8), _search(8),
        _search(64)]),
    ("read-only-then-stream", "ivf12x4>pq8x64>rr40", {}, None, [
        _search(8), ("streaming",), _search(8), ("upsert", 600, 20),
        ("delete", [600, 601, 3]), ("compact",), _search(8),
        ("upsert", 700, 5), _search(64)]),
    ("stream-ivfpq-i8", "ivf12x4>pq8x64:i8>rr64", {},
     dict(delta_capacity=32, write_bucket=16, row_capacity=N + 100,
          cell_slack=4), [
        _search(8), ("upsert", 600, 10), ("upsert", 610, 10),
        ("delete", [1, 2, 3]), ("delete", list(range(4, 40))), ("compact",),
        _search(8), ("upsert", 620, 40), _search(8), ("compact",),
        _search(8), ("upsert", 700, 20), ("upsert", 720, 20), _search(8),
        ("vacuum",),
        _search(8), ("upsert", 900, 5), ("delete", [900]), _search(64),
        ("rebuild",), _search(8), ("upsert", 1100, 3), ("compact",),
        _search(8)]),
    ("stream-flat-zero-recompile", "flat>rr64", {},
     dict(delta_capacity=128, write_bucket=32), [
        _search(8), ("upsert", 600, 1), ("upsert", 600, 5),
        ("delete", list(range(600, 605))), ("upsert", 600, 17),
        ("upsert", 600, 32), ("delete", [3] * 32), ("compact",), _search(8)]
     + [op for i in range(6) for op in (("upsert", 700 + 32 * i, 32),
                                         ("delete", [10 + i] * 8),
                                         _search(8))]),
]


def _apply(eng, op, q, jax_side, tmp_path):
    """One operation of a sequence; returns the engine (a save and load
    gives a new one)."""
    kind = op[0]
    if kind == "search":
        eng.search(q[:op[1]], op[2])
    elif kind == "cfg":
        eng.config = dataclasses.replace(eng.config, **op[1])
    elif kind == "upsert":
        eng.upsert(np.arange(op[1], op[1] + op[2]), _rows(op[1], op[2]))
    elif kind == "delete":
        eng.delete(np.asarray(op[1]))
    elif kind == "compact":
        eng.compact()
    elif kind == "vacuum":
        eng.vacuum()
    elif kind == "rebuild":
        eng.rebuild_quantizers()
    elif kind == "trace":
        eng.tracing(deep_trace_every=1, recall_every=1, slow_query_ms=0.0)
    elif kind == "streaming":
        if jax_side:
            from repro.search import StreamConfig as JStreamConfig
            eng.streaming(JStreamConfig(delta_capacity=64))
        else:
            eng.streaming(StreamConfig(delta_capacity=64))
    elif kind == "save-load":
        d = str(tmp_path / ("jax" if jax_side else "port"))
        eng.save(d)
        if jax_side:
            from repro.search import load_engine as jax_load_engine
            return jax_load_engine(d)
        from repro_torch.search import load_engine
        return load_engine(d, device="cpu")
    else:
        raise ValueError(op)
    return eng


@pytest.mark.parametrize("name,spec,runtime,scfg,ops", _SEQUENCES,
                         ids=[s[0] for s in _SEQUENCES])
def test_compile_count_matches_jax_after_every_op(tmp_path, name, spec,
                                                  runtime, scfg, ops):
    """One operation sequence through a JAX engine and a port engine
    carried across from it (the same store, so the same grows): the
    port's ``compile_count`` equals JAX's after every operation. A
    rebuild retrains with each package's own draws, so the sequence ends
    with few writes after it."""
    from repro.core import MPADConfig as JConfig
    from repro.search import StreamConfig as JStreamConfig
    from repro.search import build_engine as jax_build_engine
    from repro_torch.core.mpad import MPADConfig
    jkw = dict(runtime, fit_sample=512)
    tkw = dict(runtime, fit_sample=512)
    if spec.startswith("qpad"):
        jkw["mpad"] = JConfig(m=8, iters=8)
        tkw["mpad"] = MPADConfig(m=8, iters=8)
    if scfg is None:
        jeng = jax_build_engine(_data(), spec, **jkw)
        teng = SearchEngine.from_state(
            state_from_arrays(_state_arrays(jeng.state), spec,
                              device="cpu"), config_from_spec(spec, **tkw))
    else:
        jeng = jax_build_engine(_data(), spec, stream=JStreamConfig(**scfg),
                                **jkw)
        ts, tf = stream_from_arrays(
            _jax_store_arrays(jeng.store, jeng.frozen), spec, device="cpu")
        teng = SearchEngine.from_store(ts, tf, config_from_spec(
            spec, stream=StreamConfig(**scfg), **tkw))
    q = _rows(3, 128)
    assert teng.compile_count == jeng.compile_count == 0
    for i, op in enumerate(ops):
        jeng = _apply(jeng, op, q, True, tmp_path / str(i))
        teng = _apply(teng, op, q, False, tmp_path / str(i))
        assert teng.grow_count == jeng.grow_count, (i, op)
        assert teng.compile_count == jeng.compile_count, (
            i, op, teng.compile_count, jeng.compile_count)
        assert (teng.metrics().engine.compile_count
                == jeng.metrics().engine.compile_count)
    if name.startswith("stream-ivfpq"):
        assert teng.grow_count >= 1          # a grow re-keyed the programs


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_metrics_and_scrape_under_traced_k1_searches():
    """On the card: a traced ivfpq@kernel engine's searches launch K1,
    and a scrape taken between them renders and counts them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.pq_adc import ops as adc_ops
    eng = build_engine(_data(), "ivf12x4>pq8x64:i8@kernel>rr64",
                       device="cuda", compact_batch=0).tracing()
    q = torch.from_numpy(_rows(3, 64)).cuda()
    c0 = adc_ops.pq_adc_cells_topk.launches
    with MetricsServer(eng, port=0) as srv:
        for _ in range(3):
            eng.search(q, K)
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            text = r.read().decode()
    assert adc_ops.pq_adc_cells_topk.launches == c0 + 3
    _lint_exposition(text)
    assert "qpad_latency_queries 3" in text
    assert f"qpad_engine_compile_count {eng.compile_count}" in text
