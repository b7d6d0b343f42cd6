"""``host_ms_per_batch`` in the stream cell, where it moves the write rate (the
stream cell reports no ``qps``: its query and write rates are one step
rate, reported as ``write_rows_per_s``). Read as ``host_ms_per_batch`` reads it."""
from bench.catalog import metric_module

_BASE = metric_module("host_ms_per_batch")
NAME = "stream.host_ms_per_batch"
UNIT = _BASE.UNIT
LAYER = _BASE.LAYER
MOVES = "write_rows_per_s"
read = _BASE.read
