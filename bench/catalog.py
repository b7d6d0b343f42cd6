"""Find a cell's parts by name.

``BENCHMARK.json`` names every cell (``workloads``), configuration
(``configs``) and metric. Everything that belongs to one of them lives in
a file of its own, found by that name and nothing else:

* a configuration: ``bench/configs/<config>.json`` (the entry's ``file``);
* a traffic mix: ``bench/traffic/<traffic>.json``;
* a per-layer metric: ``bench/metrics/<metric>.py``, a module with
  ``NAME``, ``UNIT``, ``LAYER``, ``MOVES`` and ``read(record)``;
* a kernel's operation and byte count: ``bench/roofline/<kernel>.py``.

So a later change adds a cell, a mix or a metric by adding files and
entries, and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"bench_plugin_{path.parent.name}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The reader of the per-layer metric ``name``."""
    mod = _load_module(bench_dir / "metrics" / f"{name}.py", name)
    if getattr(mod, "NAME", None) != name:
        raise ValueError(f"bench/metrics/{name}.py names itself "
                         f"{getattr(mod, 'NAME', None)!r}")
    return mod


def roofline_module(kernel: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The operation and byte count of ``kernel``."""
    return _load_module(bench_dir / "roofline" / f"{kernel}.py", kernel)


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its parts loaded."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


class Benchmark:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, spec: dict, root: Path = ROOT):
        self.spec = spec
        self.root = Path(root)

    @classmethod
    def load(cls, root: Path = ROOT) -> "Benchmark":
        with open(Path(root) / "BENCHMARK.json") as f:
            return cls(json.load(f), root)

    def config(self, name: str) -> dict:
        (entry,) = [c for c in self.spec["configs"] if c["name"] == name]
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def cell_names(self) -> List[str]:
        return [w["name"] for w in self.spec["workloads"]]

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def cell(self, name: str, bench_dir: Optional[Path] = None) -> Cell:
        matches = [w for w in self.spec["workloads"] if w["name"] == name]
        if not matches:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {self.cell_names()}")
        w = matches[0]
        bench_dir = bench_dir or self.root / "bench"
        return Cell(
            name=name, config_name=w["config"], traffic_name=w["traffic"],
            chips=int(w["chips"]), config=self.config(w["config"]),
            traffic=traffic(w["traffic"], bench_dir),
            end_to_end=[m for m in self.spec["end_to_end"]
                        if self._applies(m, name)],
            per_layer=[m for m in self.spec["per_layer"]
                       if self._applies(m, name)])

    def metric_readers(self, cell: Cell,
                       bench_dir: Optional[Path] = None
                       ) -> Dict[str, ModuleType]:
        bench_dir = bench_dir or self.root / "bench"
        return {m["name"]: metric_module(m["name"], bench_dir)
                for m in cell.per_layer}
