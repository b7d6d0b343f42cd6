"""The flat kind is exact where it re-ranks every row: a ``qpad8>rr6000``
engine over 6,000 seeded rows returns the benchmark's plain reference's
top-10 ids (``bench/reference/knn.py``), and float32 distances within
1e-5 of the reference's float64 ones, the limit the benchmark's
comparison holds every cell to. The rows and queries are the benchmark's
own synthetic recipe at the tiny test size (``bench/data.py``).

No JAX here."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import data  # noqa: E402
from bench.reference import knn as ref  # noqa: E402
from repro_torch.core.mpad import MPADConfig  # noqa: E402
from repro_torch.search import build_engine  # noqa: E402

N, DIM, K = 6000, 48, 10
RECIPE = data.Recipe(dim=DIM, clusters=64, spread=32, local=16,
                     local_scale=0.4, noise=0.01, structure_seed=12345,
                     data_seed=20260101)


@pytest.fixture(scope="module")
def flat():
    gen = data.Generator(RECIPE, "cpu")
    corpus = gen.corpus(N)
    engine = build_engine(corpus, "qpad8>rr6000", device="cpu", seed=0,
                          fit_sample=256,
                          mpad=MPADConfig(m=8, b=80.0, alpha=25.0, iters=3,
                                          seed=0, backend="kernel"))
    return gen, corpus, engine


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 12345])
@pytest.mark.parametrize("batch", [1, 64, 100])
def test_flat_rerank_of_every_row_is_the_reference(flat, seed, batch):
    gen, corpus, engine = flat
    q = gen.queries(batch, seed)
    d, ids = engine.search(q, K)
    assert d.dtype == torch.float32 and ids.shape == (batch, K)
    _, want = ref.knn(q, [corpus], K)
    assert torch.equal(ids, want)
    true = ref.true_dist(q, ref.gather_rows([corpus], want))
    assert float((d.double() - true).abs().max()) <= 1e-5


def test_flat_scan_budget_below_the_rows_is_not_exact(flat):
    """The same engine at the cell's budget (64 of 6,000 rows re-ranked)
    is approximate: the guard above would see a broken scan."""
    gen, corpus, _ = flat
    engine = build_engine(corpus, "qpad8>rr64", device="cpu", seed=0,
                          fit_sample=256,
                          mpad=MPADConfig(m=8, b=80.0, alpha=25.0, iters=3,
                                          seed=0, backend="kernel"))
    q = gen.queries(256, 7)
    _, ids = engine.search(q, K)
    _, want = ref.knn(q, [corpus], K)
    hits = (want[:, :, None] == ids[:, None, :]).any(dim=2)
    assert 0.5 < float(hits.float().mean()) < 1.0
