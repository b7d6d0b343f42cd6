"""``k1_roofline`` in the stream cell, where it moves the write rate (the
stream cell reports no ``qps``: its query and write rates are one step
rate, reported as ``write_rows_per_s``). Read as ``k1_roofline`` reads it."""
from bench.catalog import metric_module

_BASE = metric_module("k1_roofline")
NAME = "stream.k1_roofline"
UNIT = _BASE.UNIT
LAYER = _BASE.LAYER
MOVES = "write_rows_per_s"
read = _BASE.read
