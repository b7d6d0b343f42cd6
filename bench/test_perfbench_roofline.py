"""K1's and K2's operation and byte counts against PERF.md's figures at
the shapes of chip_smoke.py's path 1 and path 2, and the trace reader on
a hand-made Chrome trace."""
import pytest
import torch

from bench.catalog import roofline_module
from bench.trace import read_chrome_trace

PEAKS = roofline_module("peaks")


def test_k2_at_path_2():
    """PERF.md: K2 at Q 256, N 1,000,000, M 16, K 256, k 64, int8 codes:
    4.35 G operations, bound 0.0650 ms by operations at 67 TFLOP/s."""
    call = {"tables": torch.zeros(256, 16, 256),
            "codes": torch.zeros(1_000_000, 16, dtype=torch.uint8), "k": 64}
    ops, nbytes = roofline_module("k2").count(call)
    assert ops == 256 * 1_000_000 * 17
    t, by = PEAKS.bound_s(ops, nbytes)
    assert by == "operations" and round(t * 1e3, 4) == 0.0650


def test_k1_at_path_1():
    """PERF.md: K1's cell-major entry at path 1's scan, Q 256, P 16 over
    1024 cells: the 941 probed cells' filled rows read once, 23.6 MB,
    bound 0.0070 ms by bytes. Here 941 distinct cells of 1,021 rows each
    (961,  - the rows path 1's probed cells held) reproduce it."""
    nlist, q, p = 1024, 256, 16
    cell_len = torch.full((nlist,), 1021, dtype=torch.int64)
    probe = (torch.arange(q * p) % 941).reshape(q, p)
    call = {"tables": torch.zeros(q, 16, 256), "probe": probe,
            "cell_len": cell_len,
            "codes_cell": torch.zeros(nlist, 2, 16, dtype=torch.uint8),
            "k": 64, "live": None}
    ops, nbytes = roofline_module("k1").count(call)
    assert ops == q * p * 1021 * 18
    assert nbytes == pytest.approx(23.6e6, rel=0.01)
    t, by = PEAKS.bound_s(ops, nbytes)
    assert by == "bytes" and round(t * 1e3, 4) == 0.0070


def test_k1_counts_the_live_map_when_passed():
    call = {"tables": torch.zeros(2, 4, 16), "probe": torch.tensor([[0], [0]]),
            "cell_len": torch.tensor([10, 5]),
            "codes_cell": torch.zeros(2, 12, 4, dtype=torch.uint8), "k": 3}
    k1 = roofline_module("k1")
    ops, b0 = k1.count(dict(call, live=None))
    _, b1 = k1.count(dict(call, live=torch.ones(2, 12, dtype=torch.uint8)))
    assert ops == 2 * 10 * 6 and b1 - b0 == 10


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reader():
    data = {"traceEvents": [
        _ev("bench.window", "user_annotation", 0, 100),
        _ev("bench.search", "user_annotation", 1, 20),
        _ev("bench.search", "user_annotation", 50, 20),
        _ev("aten::topk", "cpu_op", 2, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 3, 1),
        _ev("cudaLaunchKernel", "cuda_runtime", 55, 1),
        _ev("cudaLaunchKernel", "cuda_runtime", 80, 1),
        _ev("void adc_select<0>(Args)", "kernel", 10, 30),
        _ev("select_topk", "kernel", 30, 20),
        _ev("Memset", "gpu_memset", 90, 5),
    ]}
    r = read_chrome_trace(data, {"adc_select<": 1})
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx(45e-6)         # [10, 50] and [90, 95]
    assert r.n_search == 2 and r.launches_in_search == 2
    assert r.kernel_seconds("adc_select<", "select_topk") == pytest.approx(
        50e-6)
    assert not r.lost
    assert r.device_ops[0] == ["void adc_select<0>(Args)",
                               pytest.approx(30e-6)]
    gaps = dict(r.idle_gaps)
    assert gaps["bench.search/aten::topk"] == pytest.approx(10e-6)
    assert gaps["bench.search"] == pytest.approx(40e-6 - 20e-6 + 0)  \
        or sum(gaps.values()) == pytest.approx(55e-6)
    assert read_chrome_trace(data, {"adc_select<": 2}).lost == {
        "adc_select<": {"launched": 2, "traced": 1}}
