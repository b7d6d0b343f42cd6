"""Kernel K1's (cell-major entry) share of its roofline in the traced
window: the least time its calls could take (``bench/roofline/k1.py``
against the published H100 peaks) over its device time in the trace (its
scan kernels ``adc_select<...>`` and their merge passes ``select_topk``).
Nothing is read when the trace lost a K1 record or K1 did not run."""
from bench.catalog import roofline_module

NAME = "k1_roofline"
UNIT = "%"
LAYER = "kernels.pq_adc"
MOVES = "qps"


def read(record):
    t, calls = record.trace, record.k1_calls
    if t is None or not calls or "adc_select<" in t.lost or record.k2_calls:
        return None
    if t.kernel_count("adc_select<") != len(calls) or any(
            c.get("cell_len") is None for c in calls):
        return None
    k1 = roofline_module("k1")
    peaks = roofline_module("peaks")
    least = sum(peaks.bound_s(*k1.count(c))[0] for c in calls)
    spent = t.kernel_seconds("adc_select<", "select_topk")
    return 100.0 * least / spent if spent > 0 else None
