"""Compactions in the measured window: the change of the engine's
``counters["compactions"]`` over it."""

NAME = "stream.compactions"
UNIT = "compactions"
LAYER = "search.stream"
MOVES = "write_rows_per_s"


def read(record):
    if record.cell.traffic.get("writes") is None:
        return None
    return record.compactions
