"""Kernel K3's share of its roofline in the traced window of a flat cell:
the least time of one exact scan at the cell's own shape
(``bench/roofline/k3.py`` against the published H100 peaks: the padded
query bucket, the corpus rows, the Reduce stage's dims and the re-rank
budget as k), times the traced searches, over K3's device time in the
trace (its norms ``row_sqnorms``, its scan ``knn_select<...>`` and the
merge passes ``select_topk``).

The harness records no K3 inputs and counts no K3 launches against the
trace, so the reader makes its own check: nothing is read where K1 or K2
ran (their merges are ``select_topk`` too), or where the trace holds
other than one ``knn_select`` record a traced search (a lost record, or a
route that scans elsewhere)."""
from bench.catalog import roofline_module

NAME = "k3_roofline"
UNIT = "%"
LAYER = "kernels.knn_topk"
MOVES = "qps"


def _shape(cell) -> dict:
    from repro_torch.search.serve import ServeConfig
    from repro_torch.search.spec import parse_spec
    spec = parse_spec(cell.config["spec"])
    batch = int(cell.traffic["batch"])
    bucket = max(ServeConfig().query_bucket, 1 << (batch - 1).bit_length())
    return {"queries": bucket, "rows": int(cell.config["rows"]),
            "dim": spec.reduce.m, "k": spec.rerank.n}


def read(record):
    t = record.trace
    if t is None or record.k1_calls or record.k2_calls or not t.n_search:
        return None
    if t.kernel_count("adc_select<") or t.kernel_count("adc_shared_select<"):
        return None
    if t.kernel_count("knn_select") != t.n_search:
        return None
    peaks = roofline_module("peaks")
    least = t.n_search * peaks.bound_s(
        *roofline_module("k3").count(_shape(record.cell)))[0]
    spent = t.kernel_seconds("knn_select", "row_sqnorms", "select_topk")
    return 100.0 * least / spent if spent > 0 else None
