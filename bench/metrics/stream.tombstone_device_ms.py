"""Device time of the tombstones a write step: the ``write.tombstone``
program spans (the ``torch.isin`` of the step's ids over the base row ids
and the delta ids, in ``upsert`` and ``delete``) of
``repro_torch.search.tracing`` over the traced window, divided by its
steps (one ``write.delete`` call a step). Nothing to read where the
program records no spans."""

NAME = "stream.tombstone_device_ms"
UNIT = "ms"
LAYER = "search.stream"
MOVES = "write_rows_per_s"
STAGE, PER = "write.tombstone", "write.delete"


def read(record):
    from repro_torch.search import tracing
    if not hasattr(tracing, "snapshot"):
        return None
    stats = tracing.snapshot()
    stage, per = stats.get(STAGE), stats.get(PER)
    if stage is None or per is None or per.count == 0:
        return None
    return stage.device_ms / per.count
