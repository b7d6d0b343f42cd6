"""``device_idle`` in the stream cell, where it moves the write rate (the
stream cell reports no ``qps``: its query and write rates are one step
rate, reported as ``write_rows_per_s``). Read as ``device_idle`` reads it."""
from bench.catalog import metric_module

_BASE = metric_module("device_idle")
NAME = "stream.device_idle"
UNIT = _BASE.UNIT
LAYER = _BASE.LAYER
MOVES = "write_rows_per_s"
read = _BASE.read
