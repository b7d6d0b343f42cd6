"""Shared config machinery: ``ShapeDef`` and ``ArchSpec`` (port of
``repro.configs.common``).

Each architecture module exposes ``get_arch() -> ArchSpec``; the dry-run
(``launch.dryrun``) and the tests consume this one interface:

  * ``abstract_args(shape, device)`` -- the step's global arguments as
                                fake tensors (``FakeTensorMode``: shapes and
                                dtypes, no allocation), leaf for leaf JAX's
                                ``ShapeDtypeStruct`` trees
  * ``arg_specs(shape, mesh)`` / ``out_specs(shape, mesh)`` -- trees of the
                                port's ``P``, entry for entry JAX's
  * ``step_fn(shape, mesh)``  -- the **rank program**: the function one rank
                                of ``mesh`` runs on its blocks of the
                                arguments (``parallel.sharding.shard_tree``
                                under ``arg_specs``). JAX's ``step_fn(shape)``
                                is the global function that ``jit``
                                partitions over the mesh; torch has no such
                                partitioner, so the port writes each rank's
                                program itself (``parallel.step``)
  * ``smoke(device)``         -- the family's reduced config, one real step
  * ``model_flops(shape)``    -- JAX's 6ND-style count
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch._device import DeviceLike
from repro_torch._tree import tree_map

__all__ = ["ShapeDef", "ArchSpec", "fake_tensors", "abstract_tree",
           "abstract_tensor"]


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str                       # train | prefill | decode | serve
    skip: Optional[str] = None      # reason this cell is skipped (documented)
    desc: str = ""


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str                     # lm | gnn | recsys
    shapes: Dict[str, ShapeDef]
    abstract_args: Callable[[str, DeviceLike], tuple]
    arg_specs: Callable[[str, Any], tuple]
    out_specs: Callable[[str, Any], Any]
    step_fn: Callable[[str, Any], Callable]
    smoke: Callable[[DeviceLike], dict]
    model_flops: Callable[[str], float] = lambda shape: 0.0   # 6ND-style

    def runnable_shapes(self):
        return {k: v for k, v in self.shapes.items() if v.skip is None}


@contextlib.contextmanager
def fake_tensors():
    """The active ``FakeTensorMode``, or a new one for the block: tensors
    made inside hold shapes, dtypes and devices, and no memory."""
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = active_fake_mode()
    if mode is not None:
        yield mode
        return
    with FakeTensorMode() as mode:
        yield mode


def abstract_tree(make: Callable[[], Any], device: DeviceLike) -> Any:
    """``make()``'s tree (an init on the CPU) as fake tensors on
    ``device``: the init runs under ``FakeTensorMode`` (its draws make no
    numbers) and each leaf moves to ``device``."""
    with fake_tensors():
        return tree_map(lambda t: t.to(device), make())


def abstract_tensor(shape, dtype: torch.dtype, device: DeviceLike):
    """One fake tensor (JAX's ``ShapeDtypeStruct``)."""
    with fake_tensors():
        return torch.empty(tuple(shape), dtype=dtype, device=device)
