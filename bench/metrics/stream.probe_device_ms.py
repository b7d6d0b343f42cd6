"""``probe_device_ms`` in a cell that writes: the ``search.probe``
program spans' device ms over the traced window, divided by its
``search`` calls (one a step). The streaming store's posting lists carry
``cell_slack`` free slots a cell, so its candidate table is wider.
Nothing to read where the program records no spans."""

NAME = "stream.probe_device_ms"
UNIT = "ms"
LAYER = "search.serve"
MOVES = "write_rows_per_s"
STAGE, PER = "search.probe", "search"


def read(record):
    from repro_torch.search import tracing
    if not hasattr(tracing, "snapshot"):
        return None
    stats = tracing.snapshot()
    stage, per = stats.get(STAGE), stats.get(PER)
    if stage is None or per is None or per.count == 0:
        return None
    return stage.device_ms / per.count
