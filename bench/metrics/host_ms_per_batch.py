"""Host time of one ``SearchEngine.search`` call: the benchmark's
``perf_counter`` span around the call, with no synchronize, so the host's
dispatch (Python, the port's host logic and its kernel launches); the
median over the measured window's calls."""
import statistics

NAME = "host_ms_per_batch"
UNIT = "ms"
LAYER = "search.serve"
MOVES = "qps"


def read(record):
    spans = record.search_host_s
    return 1e3 * statistics.median(spans) if spans else None
