"""Architecture registry (port of ``repro.configs.registry``): ``--arch``
names to the port's configuration modules. The port has the dense and MoE
LMs and the recsys family; gin-tu raises until the GNN family is ported."""
from __future__ import annotations

import importlib
from types import ModuleType

__all__ = ["ARCH_MODULES", "NOT_PORTED", "config_module"]

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
}

# the JAX package's other architectures
NOT_PORTED = ("gin-tu",)


def config_module(name: str) -> ModuleType:
    """The configuration module of arch ``name``: ``CONFIG`` and, for an
    LM, ``SMOKE``."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (see ROADMAP.md, "
            "item 13)")
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{list(ARCH_MODULES) + list(NOT_PORTED)}")
    return importlib.import_module(ARCH_MODULES[name])
