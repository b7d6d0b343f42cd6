"""The flat cell (``cohere768-1m.flat.b1024``, kernel K3's exact scan in
QPAD's 64 dims) through the harness on the CPU at the tiny size: a sound
run comes out correct, the control and the faults come out not correct, a
traced run reads ``scan_device_ms``; ``k3_roofline`` reads K3's own
kernels only, and K3's count gives PERF.md's bound."""
import time

import pytest
import torch

from bench import harness
from bench.catalog import metric_module, roofline_module
from bench.conftest import SEED, tiny
from bench.harness import Record
from bench.test_perfbench_run_cpu import _Faulty
from bench.trace import read_chrome_trace

FLAT = "cohere768-1m.flat.b1024"
IVFPQ = "cohere768-10m.ivfpq.b1024"
PEAKS = roofline_module("peaks")
# long enough that a loaded CPU still keeps some answers for the comparison
SECONDS = 2.0


def test_sound_run_is_correct(run_tiny, bench_spec):
    r = run_tiny(FLAT, seconds=SECONDS)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    names = {m["name"] for m in bench_spec.cell(FLAT).end_to_end}
    assert set(r["metrics"]) == names == {"qps", "p95_ms", "recall_at_10",
                                          "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_control_is_refused(run_tiny):
    r = run_tiny(FLAT, control=True)
    assert not r["correct"]
    assert not r["checks"]["dist_abs_err"]["ok"]


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_fault_is_refused(run_tiny, fault):
    r = run_tiny(FLAT, seconds=SECONDS, hook=lambda e: _Faulty(e, fault))
    assert not r["correct"], r["checks"]


def test_traced_run_reads_scan_device_ms(run_tiny, bench_spec):
    r = run_tiny(FLAT, seconds=SECONDS, traced=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["scan_device_ms"]["value"] > 0
    assert r["metrics"]["rerank_device_ms"]["value"] > 0
    listed = {m["name"] for m in bench_spec.cell(FLAT).per_layer}
    assert {"k3_roofline", "scan_device_ms"} <= listed
    assert "probe_device_ms" not in listed and "k1_roofline" not in listed
    # the CPU trace holds no kernels: K3's share has nothing to read
    assert "k3_roofline" not in r["metrics"]


def test_k3_roofline_reads_nothing_in_an_ivfpq_cell(bench_spec):
    """A traced tiny run of the ivfpq cell with the flat cell's K3 reader
    added: the reader finds no K3 (and K1's calls recorded)."""
    cell = tiny(bench_spec.cell(IVFPQ))
    readers = dict(bench_spec.metric_readers(cell),
                   k3_roofline=metric_module("k3_roofline"))
    r = harness.run(cell, SEED, SECONDS, True, torch.device("cpu"),
                    time.perf_counter(), readers=readers)
    assert r["correct"], r["checks"]
    assert "probe_device_ms" in r["metrics"]
    assert "k3_roofline" not in r["metrics"]


def test_k3_at_the_flat_engine_shape():
    """PERF.md: K3 at the flat engine's shape of chip_smoke.py (Q 256,
    N 1,000,000, D 64, k 64), bound 0.489 ms by operations at 67 TFLOP/s;
    the flat cell's Q 1,024: 1.956 ms."""
    k3 = roofline_module("k3")
    ops, nbytes = k3.count({"queries": 256, "rows": 1_000_000, "dim": 64,
                            "k": 64})
    assert ops == 2 * 256 * 1_000_000 * 64
    assert nbytes == 1_000_000 * 65 * 4 + 256 * 64 * 4 + 256 * 64 * 8
    t, by = PEAKS.bound_s(ops, nbytes)
    assert by == "operations" and round(t * 1e3, 3) == 0.489
    t, _ = PEAKS.bound_s(*k3.count({"queries": 1024, "rows": 1_000_000,
                                    "dim": 64, "k": 64}))
    assert round(t * 1e3, 3) == 1.956


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _record(bench_spec, kernels, searches=2, k1_calls=()):
    ev = [_ev("bench.window", "user_annotation", 0, 10_000)]
    ev += [_ev("bench.search", "user_annotation", 10 + 4000 * i, 100)
           for i in range(searches)]
    ev += [_ev(name, "kernel", 200 + 100 * i, dur)
           for i, (name, dur) in enumerate(kernels)]
    trace = read_chrome_trace({"traceEvents": ev}, {})
    return Record(cell=bench_spec.cell(FLAT), search_host_s=[],
                  latency_ms=[], trace=trace, k1_calls=list(k1_calls),
                  k2_calls=[], compactions=0, write_sync_ms=[])


SELECT = "void (anonymous namespace)::knn_select<float, 8>(float const*)"
NORMS = "void (anonymous namespace)::row_sqnorms<float>(float const*)"
MERGE = "void (anonymous namespace)::select_topk(float const*)"


def test_k3_roofline_reads_k3_kernels_only(bench_spec):
    read = metric_module("k3_roofline").read
    k3 = [(NORMS, 10), (NORMS, 90), (SELECT, 4000), (MERGE, 100)] * 2
    got = read(_record(bench_spec, k3))
    least = 2 * PEAKS.bound_s(*roofline_module("k3").count(
        {"queries": 1024, "rows": 1_000_000, "dim": 64, "k": 64}))[0]
    assert got == pytest.approx(100 * least / 8400e-6)
    assert 0 < got <= 100
    # a lost knn_select record, or one search more than K3 launches
    assert read(_record(bench_spec, k3[:-2])) is None
    assert read(_record(bench_spec, k3, searches=3)) is None
    # K1 or K2 ran: their merges are select_topk too
    assert read(_record(bench_spec, k3 + [("void adc_select<2>()", 50)])) \
        is None
    assert read(_record(bench_spec, k3 + [
        ("void adc_shared_select<2, 8>()", 50)])) is None
    assert read(_record(bench_spec, k3, k1_calls=[{}])) is None
    assert read(_record(bench_spec, [], searches=0)) is None


def test_scan_device_ms_reads_nothing_without_spans(monkeypatch):
    from repro_torch.search import tracing
    monkeypatch.setattr(tracing, "snapshot", lambda: {})
    assert metric_module("scan_device_ms").read(None) is None
