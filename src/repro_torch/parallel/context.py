"""The mesh of ranks: one process a rank, ``torch.distributed`` collectives
(port of ``repro.parallel.context``).

The JAX package places arrays over a mesh of devices and lets XLA (or
``shard_map``) insert the collectives. The port runs SPMD, one process a
rank: every rank holds its own block of each array and runs the same
program, and the collectives it calls are ``torch.distributed``'s. A
``Mesh`` records that process's place in it.

* The **1-D serving mesh** (sharded serving): ``axis`` names the axis,
  ``size`` is the world, ``rank`` this process's shard (JAX's
  ``axis_index``), ``group`` the process group.
* An **N-D mesh** (the model side: ``("data", "model")`` or ``("pod",
  "data", "model")``) also names its axes in ``names`` with their sizes in
  ``dims`` and one process group per axis in ``groups`` (the ranks that
  share every other coordinate). Ranks are numbered as JAX lays devices
  out: row-major over the axes, so on ``("data", "model")`` rank = d * mp
  + m. ``axis`` is then its first axis and ``group`` the whole mesh's.

The record is not ``torch.distributed.device_mesh.DeviceMesh``: that ties
the backend to the device type, and several ranks on one card need gloo
with CUDA tensors (NCCL refuses two ranks on one GPU). The backend is the
caller's choice, never a fallback: ``"nccl"`` is one rank a card (the
deployment route), ``"gloo"`` serves CPU tensors and several ranks on one
card; under gloo a CUDA tensor goes through host memory (``_staged``).
``"fake"`` is torch's fake process group: one process plays one rank of a
world of any size, every collective returns at once with its output's
shape and no values moved, and tensors stay on their device as under
NCCL (the dry-run traces a rank's program at full size on fake tensors:
``launch.dryrun``).

``count_collectives()`` records the bytes each collective call's operand
takes (a rank's own block for an all-gather, its buffer for an
all-reduce, its send buffer for an all-to-all: the operand JAX's HLO
names) and the calls, by JAX's collective kind; a real run and a fake
trace count through the same wrappers.

``mesh_context`` / ``active_mesh`` / ``require_mesh`` keep the JAX
contracts: APIs that take ``mesh=None`` use the context's mesh, or raise
naming the caller. ``constrain`` is JAX's sharding constraint, which
changes placement and never values: here every rank already holds its
block, so it returns its input.

The collectives take an axis or a tuple of axes (default: every axis of
the mesh): a tiled ``all_gather`` on a given dim
(``lax.all_gather(..., tiled=True)``: the blocks concatenated in the
order JAX's ``NamedSharding`` gives a dim split over those axes),
``all_reduce_sum`` (``lax.psum``), ``all_reduce_min`` (``lax.pmin``),
``all_reduce_max`` (``lax.pmax``), ``pmean`` and a tiled ``all_to_all`` on dim 0
(``lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=True)``). Every
rank of a group gets the same result.

``use_partial`` and ``sum_partial`` bracket work split over ranks whose
partial results add up (GIN's neighbour sum over a rank's block of the
edges, as XLA partitions JAX's ``segment_sum`` over split edges): a value
every rank holds whole enters the split work through ``use_partial``, and
the partial results leave it through ``sum_partial`` (an all-reduce).

**Gradients.** The model side differentiates through
``gather_replicated``, ``gather_partial``, ``take_block``,
``all_to_all``, ``pmean``, ``use_partial`` and ``sum_partial``
(``torch.autograd.Function``s over the collectives above). Their
backward passes follow one convention: a rank's gradient is that of its
**data replica's loss** (every rank of a data-parallel group computes
the same loss on its own rows; the step takes the mean of the gradients
over the data axes once, at the end), and a
value that every rank of the other axes computes alike has the same full
gradient on each of them. So a gather whose output feeds replicated
compute passes back the rank's block with no collective (a reduce-scatter
would count the gradient once a rank), a gather whose output feeds
per-rank compute (each rank a slice of the tokens) sums the partial
gradients over the axes first, and ``take_block``'s backward gathers the
blocks' gradients; ``sum_partial``'s output feeds replicated compute, so
its backward passes the gradient through, and ``use_partial``'s backward
sums the partial gradients of the split work. An axis of size 1 runs no
collective and no Function.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["Mesh", "mesh_context", "active_mesh", "require_mesh",
           "constrain", "all_gather", "all_reduce_min", "all_reduce_max",
           "all_reduce_sum",
           "pmean", "all_to_all", "gather_replicated", "gather_partial",
           "take_block", "use_partial", "sum_partial", "count_collectives",
           "CollectiveCounts", "COLLECTIVE_KINDS"]

BACKENDS = ("nccl", "gloo", "fake")
# JAX's collective kinds (its HLO op names), the keys of the counts
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
DP_AXES = ("pod", "data")          # the data-parallel axis names

Axes = Union[None, str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a mesh of ranks (see the module docstring:
    a 1-D serving mesh leaves ``names`` / ``dims`` / ``groups`` empty).
    ``groups`` may be empty on an N-D record that only lays blocks out
    (``parallel.sharding.rank_block``) and runs no collective."""
    axis: str                 # the 1-D mesh's axis; an N-D mesh's first
    size: int                 # ranks in the mesh
    rank: int                 # this process's rank (row-major over axes)
    group: Any                # the whole mesh's torch.distributed group
    backend: str              # "nccl" (one rank a card) | "gloo" | "fake"
    device: torch.device      # where this rank's tensors live
    names: Tuple[str, ...] = ()     # an N-D mesh's axes, row-major
    dims: Tuple[int, ...] = ()      # their sizes
    groups: Tuple[Any, ...] = ()    # one process group per axis

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {BACKENDS}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside [0, {self.size})")
        if self.names:
            if (len(self.dims) != len(self.names)
                    or len(set(self.names)) != len(self.names)):
                raise ValueError(f"axes {self.names} with sizes {self.dims}")
            if math.prod(self.dims) != self.size:
                raise ValueError(f"a {self.dims} mesh has "
                                 f"{math.prod(self.dims)} ranks, not "
                                 f"{self.size}")
            if self.groups and len(self.groups) != len(self.names):
                raise ValueError("one process group per axis")
            if self.axis != self.names[0]:
                raise ValueError(f"axis {self.axis!r} is not the first of "
                                 f"{self.names}")

    @property
    def axis_names(self) -> tuple:
        return self.names or (self.axis,)

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.dims or (self.size,)))

    @property
    def coords(self) -> dict:
        """``{axis: this rank's coordinate}`` (row-major over the axes)."""
        out, r = {}, self.rank
        for name in reversed(self.axis_names):
            r, out[name] = divmod(r, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def axis_size(self, axes: Axes = None) -> int:
        """The ranks along ``axes`` (an axis, a tuple, or None: all)."""
        return math.prod(self.shape[a] for a in _axes(self, axes))

    def axis_index(self, axes: Axes = None) -> int:
        """This rank's index along ``axes`` (``lax.axis_index``; for a
        tuple (a1, a2, ...), c(a1) * |a2| * ... + c(a2) * ... + ...: the
        block a dim split over them puts here)."""
        idx = 0
        for a in _axes(self, axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def axis_group(self, name: str):
        """The process group of the ranks along axis ``name``."""
        if not self.names:
            return self.group
        if not self.groups:
            raise RuntimeError("this mesh record lays blocks out only: it "
                               "has no process groups")
        return self.groups[self.names.index(name)]


def _axes(mesh: Mesh, axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return tuple(mesh.axis_names)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"the mesh has axes {mesh.axis_names}, not "
                             f"{a!r}")
    return axes


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


def constrain(x, spec):
    """JAX's ``with_sharding_constraint`` under the active mesh. A
    constraint changes where XLA places ``x``, never its values; the port
    runs one process a rank, each already holding its block, so ``x``
    comes back unchanged. Under an active mesh a spec with more entries
    than ``x`` has dims raises, as JAX's does; axes the mesh lacks are
    ignored (JAX's ``constrain`` drops them)."""
    if active_mesh() is not None and len(spec) > x.dim():
        raise ValueError(f"a spec of {len(spec)} entries ({tuple(spec)}) "
                         f"for a {x.dim()}-d value")
    return x


# --------------------------------------------------------- collectives

@dataclasses.dataclass(eq=False)         # each block is its own counter
class CollectiveCounts:
    """Operand bytes and calls by collective kind (``COLLECTIVE_KINDS``)
    since the ``count_collectives`` block began."""
    bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0))
    calls: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0))

    @property
    def total(self) -> int:
        return sum(self.bytes.values())


_COUNTS: List[CollectiveCounts] = []


@contextlib.contextmanager
def count_collectives():
    """Count every collective this process's mesh wrappers run inside the
    ``with`` block (nested blocks each count); yields the
    ``CollectiveCounts``."""
    counts = CollectiveCounts()
    _COUNTS.append(counts)
    try:
        yield counts
    finally:
        _COUNTS.remove(counts)


def _record(kind: str, operand: torch.Tensor):
    for counts in _COUNTS:
        counts.bytes[kind] += operand.numel() * operand.element_size()
        counts.calls[kind] += 1


def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend's collective takes: gloo has no CUDA
    collectives, so under ``backend="gloo"`` a CUDA tensor goes through
    host memory (and the result comes back to its device). The choice is
    made from the mesh's backend, before the call, never by catching an
    error."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        return t.detach().to("cpu")
    return t.detach().clone()


def _one_call(mesh: Mesh, axes: Tuple[str, ...]):
    """The group a collective over ``axes`` runs on in one call: the
    axis's own, or the whole mesh's when ``axes`` are all of its axes in
    its order (its rank order is then the blocks' order); else None."""
    if len(axes) == 1:
        return mesh.axis_group(axes[0])
    if axes == tuple(mesh.axis_names):
        return mesh.group
    return None


def _gather_group(mesh: Mesh, t: torch.Tensor, group, n: int,
                  dim: int) -> torch.Tensor:
    src = _staged(mesh, t).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    _record("all-gather", src)
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_gather(mesh: Mesh, t: torch.Tensor, dim: int = 0,
               axes: Axes = None) -> torch.Tensor:
    """Tiled all-gather: every rank's ``t`` concatenated along ``dim`` in
    the order of their index along ``axes``
    (``lax.all_gather(t, axes, axis=dim, tiled=True)``)."""
    axes = _axes(mesh, axes)
    group = _one_call(mesh, axes)
    if group is not None:
        return _gather_group(mesh, t, group, mesh.axis_size(axes), dim)
    for a in reversed(axes):          # the innermost axis first
        t = _gather_group(mesh, t, mesh.axis_group(a), mesh.shape[a], dim)
    return t


def _all_reduce(mesh: Mesh, t: torch.Tensor, op, axes: Axes):
    axes = _axes(mesh, axes)
    group = _one_call(mesh, axes)
    buf = _staged(mesh, t).contiguous()
    for g in ([group] if group is not None
              else [mesh.axis_group(a) for a in axes]):
        _record("all-reduce", buf)
        dist.all_reduce(buf, op=op, group=g)
    return buf.to(t.device)


def all_reduce_min(mesh: Mesh, t: torch.Tensor,
                   axes: Axes = None) -> torch.Tensor:
    """Elementwise minimum over the ranks along ``axes`` (``lax.pmin``)."""
    return _all_reduce(mesh, t, dist.ReduceOp.MIN, axes)


def all_reduce_max(mesh: Mesh, t: torch.Tensor,
                   axes: Axes = None) -> torch.Tensor:
    """Elementwise maximum over the ranks along ``axes`` (``lax.pmax``)."""
    return _all_reduce(mesh, t, dist.ReduceOp.MAX, axes)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor,
                   axes: Axes = None) -> torch.Tensor:
    """Elementwise sum over the ranks along ``axes`` (``lax.psum``)."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM, axes)


def _block(mesh: Mesh, t: torch.Tensor, axes: Tuple[str, ...],
           dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} ({t.shape[dim]}) is not a multiple of "
                         f"the {n} ranks along {axes}")
    per = t.shape[dim] // n
    return t.narrow(dim, mesh.axis_index(axes) * per, per)


def _all_to_all(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    n = mesh.shape[axis]
    if t.shape[0] % n:
        raise ValueError(f"dim 0 ({t.shape[0]}) is not a multiple of the "
                         f"{n} ranks along {axis!r}")
    src = _staged(mesh, t).contiguous()
    out = torch.empty_like(src)
    _record("all-to-all", src)
    dist.all_to_all_single(out, src, group=mesh.axis_group(axis))
    return out.to(t.device)


def _owned(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(mesh, t, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return _owned(_block(ctx.mesh, g, ctx.axes, ctx.dim)), None, None, \
            None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(mesh, t, dim, axes)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_sum(ctx.mesh, g, ctx.axes)
        return _owned(_block(ctx.mesh, total, ctx.axes, ctx.dim)), None, \
            None, None


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _owned(_block(mesh, t, axes, dim))

    @staticmethod
    def backward(ctx, g):
        return all_gather(ctx.mesh, g, ctx.dim, ctx.axes), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all(mesh, t, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.mesh, g, ctx.axis), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        n = mesh.axis_size(axes)
        # the data replicas' mean is the step's: only the other axes'
        # share of the mean reaches this rank's gradient
        ctx.scale = mesh.axis_size(tuple(a for a in axes if a in DP_AXES)) \
            / n
        return all_reduce_sum(mesh, t, axes) / n

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


class _UsePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(ctx.mesh, g, ctx.axes), None, None


class _SumPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce_sum(mesh, t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _live(mesh: Mesh, axes: Axes) -> Tuple[str, ...]:
    """``axes`` less those of size 1 (no collective runs over them)."""
    return tuple(a for a in _axes(mesh, axes) if mesh.shape[a] > 1)


def gather_replicated(mesh: Mesh, t: torch.Tensor, axes: Axes,
                      dim: int) -> torch.Tensor:
    """Tiled all-gather of ``t``'s blocks along ``dim`` over ``axes``, for
    a value every rank of ``axes`` then uses alike (a parameter gathered
    at use, EP's output); its backward keeps this rank's block of the
    gradient, with no collective."""
    axes = _live(mesh, axes)
    return _GatherReplicated.apply(t, mesh, axes, dim) if axes else t


def gather_partial(mesh: Mesh, t: torch.Tensor, axes: Axes,
                   dim: int) -> torch.Tensor:
    """Tiled all-gather along ``dim`` over ``axes``, for a value each rank
    uses on its own slice of the work (EP's router): its backward sums
    the ranks' partial gradients over ``axes`` and keeps this rank's
    block (a reduce-scatter)."""
    axes = _live(mesh, axes)
    return _GatherPartial.apply(t, mesh, axes, dim) if axes else t


def take_block(mesh: Mesh, t: torch.Tensor, axes: Axes,
               dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of a value every rank of ``axes``
    holds alike (EP's slice of the tokens); its backward all-gathers the
    blocks' gradients."""
    axes = _live(mesh, axes)
    return _TakeBlock.apply(t, mesh, axes, dim) if axes else t


def all_to_all(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """Tiled all-to-all over ``axis`` on dim 0: block j of ``t``'s dim 0
    goes to rank j, and block i of the result came from rank i
    (``lax.all_to_all(t, axis, 0, 0, tiled=True)``). Differentiable (its
    backward is the same exchange)."""
    if mesh.shape[_axes(mesh, axis)[0]] == 1:
        return t
    return _AllToAll.apply(t, mesh, axis)


def pmean(mesh: Mesh, t: torch.Tensor, axes: Axes = None) -> torch.Tensor:
    """The mean over the ranks along ``axes`` (``lax.pmean``).
    Differentiable under the module's convention: the gradient reaching
    this rank's ``t`` is the output's over the number of ranks along the
    non-data axes of ``axes`` (the data axes' mean is the step's)."""
    axes = _live(mesh, axes)
    return _PMean.apply(t, mesh, axes) if axes else t


def use_partial(mesh: Mesh, t: torch.Tensor, axes: Axes = None
                ) -> torch.Tensor:
    """``t`` (a value every rank of ``axes`` holds alike) as the input of
    work each rank does on its own part (its block of a graph's edges):
    the identity, whose backward sums the ranks' partial gradients over
    ``axes``."""
    axes = _live(mesh, axes)
    return _UsePartial.apply(t, mesh, axes) if axes else t


def sum_partial(mesh: Mesh, t: torch.Tensor, axes: Axes = None
                ) -> torch.Tensor:
    """The sum over the ranks along ``axes`` of each rank's partial
    result ``t``, which every rank then uses alike (an all-reduce); its
    backward passes the gradient through to each rank's part."""
    axes = _live(mesh, axes)
    return _SumPartial.apply(t, mesh, axes) if axes else t
