"""Host syncs of the write path a step: the ``host_syncs`` counted in the
``write.*`` program spans (``upsert``, ``delete``, their tombstones and
any compaction they trigger) of ``repro_torch.search.tracing`` over the
traced window, divided by its steps (one ``write.delete`` call a step).
Nothing to read where the program records no spans."""

NAME = "stream.write_syncs_per_step"
UNIT = "syncs"
LAYER = "search.stream"
MOVES = "write_rows_per_s"
PER = "write.delete"


def read(record):
    from repro_torch.search import tracing
    if not hasattr(tracing, "snapshot"):
        return None
    stats = tracing.snapshot()
    per = stats.get(PER)
    if per is None or per.count == 0:
        return None
    syncs = sum(s.counts.get("host_syncs", 0) for name, s in stats.items()
                if name.startswith("write."))
    return syncs / per.count
