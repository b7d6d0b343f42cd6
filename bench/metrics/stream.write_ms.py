"""One write step's time (``SearchEngine.upsert`` of the step's rows,
then ``delete``, and any compaction they trigger): the benchmark's span
around the step, synchronized before and after, in the traced run's
write-span window; the mean over its steps, so the compactions' share
counts."""
import statistics

NAME = "stream.write_ms"
UNIT = "ms"
LAYER = "search.stream"
MOVES = "write_rows_per_s"


def read(record):
    ms = record.write_sync_ms
    return statistics.fmean(ms) if ms else None
