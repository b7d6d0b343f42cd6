"""Kernel K2's share of its roofline in the traced window: the least time
its calls could take (``bench/roofline/k2.py`` against the published H100
peaks) over its device time in the trace (its scan kernels
``adc_shared_select<...>`` and their merge passes ``select_topk``).
Nothing is read when the trace lost a K2 record or K2 did not run."""
from bench.catalog import roofline_module

NAME = "k2_roofline"
UNIT = "%"
LAYER = "kernels.pq_adc"
MOVES = "qps"


def read(record):
    t, calls = record.trace, record.k2_calls
    if t is None or not calls or "adc_shared_select<" in t.lost \
            or record.k1_calls:
        return None
    if t.kernel_count("adc_shared_select<") != len(calls):
        return None
    k2 = roofline_module("k2")
    peaks = roofline_module("peaks")
    least = sum(peaks.bound_s(*k2.count(c))[0] for c in calls)
    spent = t.kernel_seconds("adc_shared_select<", "select_topk")
    return 100.0 * least / spent if spent > 0 else None
