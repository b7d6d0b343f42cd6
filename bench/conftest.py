"""Fixtures of the benchmark's own tests: a cell of ``BENCHMARK.json`` cut
to a size the CPU runs in seconds (the port's plain kernel versions, the
same harness, traffic and comparison)."""
import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

SEED = 2 ** 31 + 12345       # larger than 32 signed bits hold


def tiny(cell):
    """``cell`` at a CPU test's size: 6,000 x 48 rows, 4 x 64 queries, the
    spec's stages kept with smaller knobs."""
    c = copy.deepcopy(cell)
    spec = c.config["spec"].replace("qpad64", "qpad8")
    spec = spec.replace("ivf4096x32", "ivf32x4").replace("pq16x256",
                                                         "pq4x64")
    c.config.update(rows=6000, dim=48, spec=spec)
    c.config["synthetic"]["clusters"] = 64
    c.config["engine"]["fit_sample"] = 256
    c.config["engine"]["mpad"].update(m=8, iters=3)
    t = c.traffic
    t.update(batch=64, query_pool_batches=4, control_units=20)
    t["keep"] = {"every": 2, "slots": 2048}
    if "queries" in t["sample"]:
        t["sample"]["queries"] = 128
    else:
        t["sample"].update(steps=3, per_step=32)
    if t.get("writes"):
        t["writes"].update(overwrite=16, fresh=16, delete=16,
                           write_queries=8)
        t["writes"]["stream_config"] = dict(
            delta_capacity=128, cell_slack=64, row_capacity_extra=4096,
            background_compact=False)
    t["trace"]["units"] = 4
    if "write_sync_units" in t["trace"]:
        t["trace"]["write_sync_units"] = 4
    return c


@pytest.fixture(scope="module")
def bench_spec():
    from bench.catalog import Benchmark
    return Benchmark.load(ROOT)


@pytest.fixture
def run_tiny(bench_spec):
    """Run a cell of ``BENCHMARK.json`` at the tiny size on the CPU."""
    import torch

    from bench import harness

    def go(name, seconds=0.5, traced=False, control=False, hook=None):
        cell = tiny(bench_spec.cell(name))
        readers = bench_spec.metric_readers(cell) if traced else None
        return harness.run(cell, SEED, seconds, traced, torch.device("cpu"),
                           time.perf_counter(), engine_hook=hook,
                           control=control, readers=readers)
    return go
