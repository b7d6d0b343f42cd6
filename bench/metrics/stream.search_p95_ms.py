"""The stream cell's search tail: the 95th percentile of every search
batch's latency in the measured window (submission to completion event,
as the end-to-end ``p95_ms`` of the read-only cells), read in the traced
run. A per-layer metric here: the write path's host syncs and blocking
compactions make it swing more than the read-only cells' tail."""
import numpy as np

NAME = "stream.search_p95_ms"
UNIT = "ms"
LAYER = "search.stream"
MOVES = "write_rows_per_s"


def read(record):
    if record.cell.traffic.get("writes") is None or not record.latency_ms:
        return None
    return float(np.percentile(record.latency_ms, 95))
