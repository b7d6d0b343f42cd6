"""The serving mesh: one process a shard, ``torch.distributed`` collectives
(port of ``repro.parallel.context``, the serving part).

The JAX package shards the database axis with ``shard_map`` over a 1-D
``"data"`` mesh of devices. The port runs it SPMD, one process a shard:
every rank holds its own slice of the database and runs the same search,
and the collectives the bodies call are ``torch.distributed``'s. A
``Mesh`` records that process's place in it: the axis name, the world
``size``, this process's ``rank`` (JAX's ``axis_index``), the process
``group``, the ``backend`` and the ``device`` the rank serves from.

The record is not ``torch.distributed.device_mesh.DeviceMesh``: that ties
the backend to the device type, and several ranks on one card need gloo
with CUDA tensors (NCCL refuses two ranks on one GPU). The backend is the
caller's choice, never a fallback: ``"nccl"`` is one rank a card (the
deployment route), ``"gloo"`` serves CPU tensors and several ranks on one
card.

``mesh_context`` / ``active_mesh`` / ``require_mesh`` keep the JAX
contracts: APIs that take ``mesh=None`` use the context's mesh, or raise
naming the caller. The collectives are the three the bodies need: a tiled
``all_gather`` on a given dim (``lax.all_gather(..., tiled=True)``: the
ranks' blocks concatenated in rank order), ``all_reduce_min``
(``lax.pmin``) and ``all_reduce_sum`` (``lax.psum``). Every rank gets the
same result.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "mesh_context", "active_mesh", "require_mesh",
           "all_gather", "all_reduce_min", "all_reduce_sum"]

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D serving mesh."""
    axis: str                 # the mesh axis name (JAX's "data")
    size: int                 # ranks on the axis (the shard count)
    rank: int                 # this process's shard (JAX's axis_index)
    group: Any                # the torch.distributed process group
    backend: str              # "nccl" (one rank a card) | "gloo"
    device: torch.device      # where this rank's tensors live

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {BACKENDS}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside [0, {self.size})")

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as a JAX mesh's ``shape``."""
        return {self.axis: self.size}

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)


_ACTIVE: List[Mesh] = []


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    """Make ``mesh`` the active mesh inside the ``with`` block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def require_mesh(what: str = "this operation") -> Mesh:
    """The active mesh, or a clear error naming the caller (for APIs that
    take ``mesh=None`` as "use the context's", e.g. ``shard_engine``)."""
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError(
            f"{what} needs a device mesh: pass mesh= explicitly or activate "
            "one with repro_torch.parallel.context.mesh_context(...)")
    return mesh


def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend's collective takes: gloo has no CUDA
    collectives, so under ``backend="gloo"`` a CUDA tensor goes through
    host memory (and the result comes back to its device). The choice is
    made from the mesh's backend, before the call, never by catching an
    error."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        return t.detach().to("cpu")
    return t.detach().clone()


def all_gather(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather: every rank's ``t`` concatenated along ``dim`` in
    rank order (``lax.all_gather(t, axis, axis=dim, tiled=True)``)."""
    src = _staged(mesh, t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=dim).to(t.device)


def _all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    buf = _staged(mesh, t).contiguous()
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(t.device)


def all_reduce_min(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum over the ranks (``lax.pmin``)."""
    return _all_reduce(mesh, t, dist.ReduceOp.MIN)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum over the ranks (``lax.psum``)."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)
