"""Kernel launches a search batch: the profiler's host-side CUDA launch
records (runtime and driver launch calls) inside the traced window's
``bench.search`` spans, divided by the number of those spans."""

NAME = "launches_per_batch"
UNIT = "launches"
LAYER = "search.serve"
MOVES = "qps"


def read(record):
    t = record.trace
    if t is None or not t.n_search or not t.launches_in_search:
        return None
    return t.launches_in_search / t.n_search
