"""The flat cell at the tiny size on the card (``gpu`` marker: skips
without one): every search launches kernel K3 once and K1 and K2 never,
the traced run reads K3's roofline share, and the control is refused."""
import time

import pytest
import torch

from bench.conftest import SEED, tiny

FLAT = "cohere768-1m.flat.b1024"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class _Counted:
    """The engine, counting its search calls."""

    def __init__(self, engine):
        self._e, self.searches = engine, 0

    def __getattr__(self, name):
        return getattr(self._e, name)

    def search(self, q, k):
        self.searches += 1
        return self._e.search(q, k)


def _launches():
    from repro_torch.kernels.knn_topk import ops as k3
    from repro_torch.kernels.pq_adc import ops as pq
    return {"k3": k3.knn_topk_d2.launches,
            "k1": pq.pq_adc_cells_topk.launches
            + pq.pq_adc_gather_topk.launches,
            "k2": pq.pq_adc_topk.launches}


@pytest.mark.gpu
def test_tiny_flat_cell_on_the_card(cuda, bench_spec):
    from bench import harness
    c = tiny(bench_spec.cell(FLAT))
    seen = {}

    def hook(engine):
        seen["engine"], seen["before"] = _Counted(engine), _launches()
        return seen["engine"]

    r = harness.run(c, SEED, 0.5, True, cuda, time.perf_counter(),
                    engine_hook=hook, readers=bench_spec.metric_readers(c))
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    after = _launches()
    searches = seen["engine"].searches
    assert searches > 0
    assert {k: after[k] - seen["before"][k] for k in after} == {
        "k3": searches, "k1": 0, "k2": 0}
    assert 0 < r["metrics"]["k3_roofline"]["value"] <= 100
    assert r["metrics"]["scan_device_ms"]["value"] > 0
    assert r["metrics"]["launches_per_batch"]["value"] > 0
    ctl = harness.run(c, SEED, 0.5, False, cuda, time.perf_counter(),
                      control=True)
    assert not ctl["correct"]
