"""Architecture registry (port of ``repro.configs.registry``): ``--arch``
names to the port's configuration modules. The port has the three dense
LMs; every other architecture of the JAX package (the MoE LMs, the recsys,
GNN and two-tower models) raises until its model family is ported."""
from __future__ import annotations

import importlib
from types import ModuleType

__all__ = ["ARCH_MODULES", "NOT_PORTED", "config_module"]

ARCH_MODULES = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
}

# the JAX package's other architectures, in its registry's order
NOT_PORTED = ("granite-moe-1b-a400m", "olmoe-1b-7b", "gin-tu", "sasrec",
              "dien", "autoint", "two-tower-retrieval")


def config_module(name: str) -> ModuleType:
    """The configuration module (``CONFIG``, ``SMOKE``) of arch ``name``."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (see ROADMAP.md, "
            "item 13)")
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{list(ARCH_MODULES) + list(NOT_PORTED)}")
    return importlib.import_module(ARCH_MODULES[name])
