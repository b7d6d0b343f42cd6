"""BENCHMARK.json keeps to the benchmark's contract, and a cell's parts
are files found by name: a new configuration, traffic mix or per-layer
metric is taken up by adding files and entries, with no edit."""
import json
import re
import shutil

import pytest

from bench.catalog import Benchmark, metric_module
from bench.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"]
    assert spec["command"][:2] == ["python3", "bench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


def test_configs_and_cells():
    spec = _spec()
    names = [c["name"] for c in spec["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["name"] in used
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        with open(ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(spec["workloads"])


def test_metrics():
    spec = _spec()
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        mod = metric_module(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                    m["moves"])
    layers = {m["layer"] for m in spec["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


@pytest.mark.parametrize("cell", [w["name"] for w in _spec()["workloads"]])
def test_every_cell_reports_enough(cell):
    c = Benchmark.load(ROOT).cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_new_files_are_taken_up_without_an_edit(tmp_path):
    """A copy of the benchmark with one more configuration, mix, metric
    and cell, added as files and entries only."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = _spec()
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    cfg = json.loads((ROOT / spec["configs"][0]["file"]).read_text())
    cfg.update(name="cohere768-1m-ivfpq", rows=1000000)
    (tmp_path / "bench/configs/cohere768-1m-ivfpq.json").write_text(
        json.dumps(cfg))
    (tmp_path / "bench/traffic/closed_b64.json").write_text(json.dumps(
        dict(json.loads((ROOT / "bench/traffic/closed_b1024.json")
                        .read_text()), name="closed_b64", batch=64)))
    (tmp_path / "bench/metrics/search_calls.py").write_text(
        'NAME = "search_calls"\nUNIT = "calls"\nLAYER = "search.serve"\n'
        'MOVES = "qps"\n\n\ndef read(record):\n'
        '    return len(record.search_host_s) or None\n')
    spec["configs"].append(dict(spec["configs"][0], name="cohere768-1m-ivfpq",
                                file="bench/configs/cohere768-1m-ivfpq.json"))
    spec["workloads"].append(dict(name="cohere768-1m.ivfpq.b64",
                                  config="cohere768-1m-ivfpq",
                                  traffic="closed_b64", chips=1, why="x"))
    spec["per_layer"].append(dict(name="search_calls", unit="calls",
                                  better="higher", source="host_clock",
                                  layer="search.serve", moves="qps",
                                  workloads=["cohere768-1m.ivfpq.b64"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Benchmark.load(tmp_path)
    cell = bench.cell("cohere768-1m.ivfpq.b64", tmp_path / "bench")
    assert cell.config["rows"] == 1000000 and cell.traffic["batch"] == 64
    readers = bench.metric_readers(cell, tmp_path / "bench")
    assert "search_calls" in readers
    assert readers["search_calls"].read(
        type("R", (), {"search_host_s": [0.1, 0.2]})()) == 2
    # nothing that was there changed
    for rel, body in before.items():
        assert (tmp_path / rel).read_bytes() == body
