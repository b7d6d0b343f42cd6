"""Device time of the exact delta scan a step: the ``search.delta_scan``
program spans (the delta segment's live slots scored in the scan space,
top-n_cand) of ``repro_torch.search.tracing`` over the traced window,
divided by its ``search`` calls (one a step). Nothing to read where the
program records no spans."""

NAME = "stream.delta_scan_device_ms"
UNIT = "ms"
LAYER = "search.stream"
MOVES = "write_rows_per_s"
STAGE, PER = "search.delta_scan", "search"


def read(record):
    from repro_torch.search import tracing
    if not hasattr(tracing, "snapshot"):
        return None
    stats = tracing.snapshot()
    stage, per = stats.get(STAGE), stats.get(PER)
    if stage is None or per is None or per.count == 0:
        return None
    return stage.device_ms / per.count
