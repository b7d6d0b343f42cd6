"""The harness at the tiny size on the card (``gpu`` marker: skips
without one). The cells themselves run through ``bench/run.py``."""
import time

import pytest
import torch

from bench.conftest import SEED, tiny


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["cohere768-10m.ivfpq.b1024",
                                  "openai1536-5m.pq.b1024",
                                  "cohere768-10m.ivfpq.stream"])
def test_tiny_cell_on_the_card(cuda, bench_spec, cell):
    from bench import harness
    c = tiny(bench_spec.cell(cell))
    r = harness.run(c, SEED, 0.5, True, cuda, time.perf_counter(),
                    readers=bench_spec.metric_readers(c))
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    ctl = harness.run(c, SEED, 0.5, False, cuda, time.perf_counter(),
                      control=True)
    assert not ctl["correct"]
