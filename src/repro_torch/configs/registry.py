"""Architecture registry (port of ``repro.configs.registry``): ``--arch``
names to the port's configuration modules: the dense and MoE LMs, the
recsys family and the GNN family (gin-tu), every arch of the JAX
package. ``get_arch(name)`` is the module's ``get_arch()`` (cached)."""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

from .common import ArchSpec

__all__ = ["ARCH_MODULES", "config_module", "get_arch", "all_arch_names"]

ARCH_MODULES = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "sasrec": "repro_torch.configs.sasrec",
    "dien": "repro_torch.configs.dien",
    "autoint": "repro_torch.configs.autoint",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "gin-tu": "repro_torch.configs.gin_tu",
}


def config_module(name: str) -> ModuleType:
    """The configuration module of arch ``name``: ``CONFIG`` and, for an
    LM, ``SMOKE``; for a non-LM arch ``smoke(device)``, its family's smoke
    step (gin-tu's shapes are in ``configs.gnn_family``, the recsys archs'
    in ``configs.recsys_family``)."""
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[name])


_cache: Dict[str, ArchSpec] = {}


def get_arch(name: str) -> ArchSpec:
    """Arch ``name``'s ``ArchSpec`` (built once)."""
    if name not in _cache:
        _cache[name] = config_module(name).get_arch()
    return _cache[name]


def all_arch_names():
    return list(ARCH_MODULES)
