"""The plain reference against brute force in NumPy, the write schedule
and its live-row ledger, and the control's TF32 rounding."""
import numpy as np
import pytest
import torch

from bench.reference import knn as ref
from bench.writes import Ledger, WritePlan


def _brute(q, x, k, live=None):
    d2 = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64))
          ** 2).sum(-1)
    if live is not None:
        d2 = np.where(live, d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d2, idx, 1), idx


@pytest.mark.parametrize("block", [7, 64, 1 << 18])
def test_knn_matches_brute_force(block):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    q = rng.standard_normal((17, 24)).astype(np.float32)
    d2, rows = ref.knn(torch.from_numpy(q), [torch.from_numpy(x[:100]),
                                             torch.from_numpy(x[100:])], 5,
                       block=block)
    want_d, want_i = _brute(q, x, 5)
    assert np.array_equal(rows.numpy(), want_i)
    np.testing.assert_allclose(d2.numpy(), want_d, rtol=1e-5, atol=1e-5)


def test_knn_honours_live_intervals():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((200, 16)).astype(np.float32)
    q = rng.standard_normal((9, 16)).astype(np.float32)
    start = rng.integers(-1, 5, 200)
    end = start + rng.integers(1, 6, 200)
    step = rng.integers(0, 8, 9)
    live = (start[None] <= step[:, None]) & (step[:, None] < end[None])
    _, rows = ref.knn(torch.from_numpy(q), [torch.from_numpy(x)], 4,
                      step=torch.from_numpy(step),
                      start=torch.from_numpy(start),
                      end=torch.from_numpy(end), block=50)
    _, want = _brute(q, x, 4, live)
    ok = np.take_along_axis(live, want, 1)
    assert np.array_equal(np.where(ok, want, -1), rows.numpy())


def test_true_dist_and_gather():
    x = torch.randn(10, 6)
    rows = torch.tensor([[3, -1], [9, 0]])
    v = ref.gather_rows([x[:4], x[4:]], rows)
    assert torch.equal(v[0, 0], x[3]) and torch.isnan(v[0, 1]).all()
    q = torch.randn(2, 6)
    d = ref.true_dist(q, v)
    assert abs(float(d[1, 0]) - float((q[1] - x[9]).norm())) < 1e-6


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10])
    r = ref.round_tf32(x)
    assert r.tolist() == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]


def test_write_plan_and_ledger():
    n, seed = 50, 7
    plan = WritePlan(n, seed, overwrite=4, fresh=3, delete=3)
    steps = [plan.step() for _ in range(6)]
    again = WritePlan(n, seed, overwrite=4, fresh=3, delete=3)
    for (u, d), (u2, d2) in zip(steps, [again.step() for _ in range(6)]):
        assert np.array_equal(u, u2) and np.array_equal(d, d2)
    live = set(range(n))
    truth = []                                 # (step, id -> row)
    cur = {i: i for i in range(n)}
    for s, (up, dl) in enumerate(steps):
        assert set(up[:4]) <= live and not set(up[4:]) & live
        assert set(dl) <= live and not set(dl) & set(up)
        for j, i in enumerate(up):
            cur[int(i)] = n + s * 7 + j
        for i in dl:
            del cur[int(i)]
        live = (live | set(int(i) for i in up)) - set(int(i) for i in dl)
        assert len(live) == n
        truth.append(dict(cur))
    led = Ledger(n, steps, 7, 5)
    ids = np.arange(n + 20).reshape(1, -1).repeat(6, 0)
    rows = led.rows_at(np.arange(6), ids)
    for s in range(6):
        for i in range(n + 20):
            assert rows[s, i] == truth[s].get(i, -1)
            if rows[s, i] >= 0:
                r = rows[s, i]
                assert led.start[r] <= s < led.end[r]
                assert led.row_id[r] == i


def test_read_only_ledger_maps_ids_to_rows():
    led = Ledger(10, [], 0, -1)
    got = led.rows_at(np.array([0, 5]), np.array([[3, -1, 10], [9, 0, 11]]))
    assert got.tolist() == [[3, -1, -1], [9, 0, -1]]
