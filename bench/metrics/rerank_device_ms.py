"""Device time of the exact re-rank a batch: the ``search.rerank``
program spans (dedupe, the gather of the candidates' rows, the exact
distances, top-k, external ids) of ``repro_torch.search.tracing``, each
timed between CUDA events at its ends, summed over the traced window and
divided by its ``search`` calls. Nothing to read where the program
records no spans."""

NAME = "rerank_device_ms"
UNIT = "ms"
LAYER = "search.serve"
MOVES = "qps"
STAGE, PER = "search.rerank", "search"


def read(record):
    from repro_torch.search import tracing
    if not hasattr(tracing, "snapshot"):
        return None
    stats = tracing.snapshot()
    stage, per = stats.get(STAGE), stats.get(PER)
    if stage is None or per is None or per.count == 0:
        return None
    return stage.device_ms / per.count
