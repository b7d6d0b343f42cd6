"""The harness end to end on the CPU at a tiny size: a sound run comes
out correct, the control and each fault a cell can have come out not
correct, and the result line has the keys the contract names."""
import json
import subprocess
import sys

import pytest
import torch

from bench.conftest import ROOT

READ_ONLY = "cohere768-10m.ivfpq.b1024"
PQ = "openai1536-5m.pq.b1024"
STREAM = "cohere768-10m.ivfpq.stream"
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _sound(result):
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    for k in KEYS:
        assert k in result
    for c in result["checks"].values():
        assert set(c) == {"value", "limit", "rule", "ok"}


@pytest.mark.parametrize("cell", [READ_ONLY, PQ, STREAM])
def test_sound_run_is_correct(run_tiny, bench_spec, cell):
    r = _sound_and_metrics(run_tiny, bench_spec, cell)
    assert r["attempted"] > 0 and r["failed"] == 0


def _sound_and_metrics(run_tiny, bench_spec, cell):
    r = run_tiny(cell)
    _sound(r)
    names = {m["name"] for m in bench_spec.cell(cell).end_to_end}
    assert set(r["metrics"]) == names
    assert all(m["value"] > 0 for m in r["metrics"].values())
    return r


@pytest.mark.parametrize("cell", [READ_ONLY, STREAM])
def test_traced_run_reads_its_per_layer_metrics(run_tiny, cell):
    r = run_tiny(cell, traced=True)
    _sound(r)
    pre = "stream." if cell == STREAM else ""
    assert pre + "host_ms_per_batch" in r["metrics"]
    assert pre + "device_idle" in r["metrics"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    if cell == STREAM:
        assert r["metrics"]["stream.write_ms"]["value"] > 0
        assert r["metrics"]["stream.compactions"]["value"] >= 1


@pytest.mark.parametrize("cell", [READ_ONLY, PQ, STREAM])
def test_control_is_refused(run_tiny, cell):
    r = run_tiny(cell, control=True)
    assert not r["correct"]
    assert not r["checks"]["dist_abs_err"]["ok"]


class _Faulty:
    """The engine with its timed path broken underneath."""

    def __init__(self, engine, fault):
        self._e, self._fault = engine, fault

    def __getattr__(self, name):
        return getattr(self._e, name)

    def upsert(self, ids, vectors):
        if self._fault == "unchanged":
            return self               # the step returns its state as is
        return self._e.upsert(ids, vectors)

    def delete(self, ids):
        if self._fault == "unchanged":
            return self
        return self._e.delete(ids)

    def search(self, q, k):
        d, ids = self._e.search(q, k)
        if self._fault == "half":     # half of the batch left out
            h = q.shape[0] // 2
            d, ids = d.clone(), ids.clone()
            d[h:], ids[h:] = float("inf"), -1
        elif self._fault == "altered":  # one answer altered where made
            ids = ids.clone()
            ids[:, 0] = (ids[:, 0] + 1) % 6000
        return d, ids


@pytest.mark.parametrize("cell,fault", [
    (READ_ONLY, "half"), (READ_ONLY, "altered"), (PQ, "half"),
    (PQ, "altered"), (STREAM, "half"), (STREAM, "altered"),
    (STREAM, "unchanged")])
def test_fault_is_refused(run_tiny, cell, fault):
    r = run_tiny(cell, hook=lambda e: _Faulty(e, fault))
    assert not r["correct"], r["checks"]


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", READ_ONLY, "--seed",
         "3000000017", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    p = _cli(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_bench_alone_gives_no_result(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_result_line_is_the_last_line_of_stdout(run_tiny):
    r = run_tiny(READ_ONLY)
    line = json.dumps(r)
    assert json.loads(line)["checks"] == r["checks"]
