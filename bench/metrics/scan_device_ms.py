"""Device time of the scan stage a batch: the ``search.scan`` program
spans of ``repro_torch.search.tracing`` (on the flat kind kernel K3's
exact scan of the reduced rows; on ivfpq the ADC tables, K1 and the
selected slots' ids), each timed between CUDA events at its ends, summed
over the traced window and divided by its ``search`` calls. Nothing to
read where the program records no spans."""

NAME = "scan_device_ms"
UNIT = "ms"
LAYER = "search.serve"
MOVES = "qps"
STAGE, PER = "search.scan", "search"


def read(record):
    from repro_torch.search import tracing
    if not hasattr(tracing, "snapshot"):
        return None
    stats = tracing.snapshot()
    stage, per = stats.get(STAGE), stats.get(PER)
    if stage is None or per is None or per.count == 0:
        return None
    return stage.device_ms / per.count
