"""Split markers for the serving state (port of the serving part of
``repro.parallel.sharding``).

Where the JAX package places each leaf by a ``PartitionSpec`` over a
device mesh, the port's ranks each keep a block of it: a leaf's marker
says which. ``ROWS`` and ``CELLS`` split dim 0 into per-rank blocks (the
database axis: corpus rows, row-major codes, or cells of the cell-major
posting structures); ``REPLICATED`` keeps the leaf whole on every rank.
The LM, recsys and gnn spec sets are not ported (ROADMAP.md item 13).
"""
from __future__ import annotations

from typing import Any

from repro_torch._tree import tree_map
from repro_torch.search.registry import CELLS, REPLICATED, ROWS

__all__ = ["dp_axes", "engine_state_specs", "replicate_like", "rank_block",
           "ROWS", "CELLS", "REPLICATED"]


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of ``mesh``: its axis when it is ``pod`` or
    ``data``."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def rank_block(mesh, leaf, marker, copy: bool = False):
    """This rank's block of ``leaf`` under its split ``marker``: a ``ROWS``
    or ``CELLS`` leaf's dim 0 cut into ``mesh.size`` equal blocks (a
    copy, so the whole tensor can be freed); a ``REPLICATED`` leaf passes
    through, and so does a split one on a mesh of one rank unless
    ``copy``."""
    if marker not in (ROWS, CELLS) or (mesh.size == 1 and not copy):
        return leaf
    n = leaf.shape[0]
    if n % mesh.size:
        raise ValueError(f"dim 0 of a split leaf ({n}) is not a multiple "
                         f"of the {mesh.size} ranks")
    per = n // mesh.size
    return leaf[mesh.rank * per:(mesh.rank + 1) * per].clone()


def replicate_like(tree: Any) -> Any:
    """``REPLICATED`` for every leaf of ``tree``."""
    return tree_map(lambda _: REPLICATED, tree)


def engine_state_specs(state, axis: str = "data"):
    """A ``ShardedEngineState`` -> the same structure of split markers:
    the corpus rows split, the reducer replicated (the ``Reducer`` whole),
    ``n_real`` replicated, the kind's payload marked by the registry
    (``IndexOps.payload_specs``)."""
    from repro_torch.search.registry import Index, get_ops
    return type(state)(
        corpus=ROWS,
        proj=None if state.proj is None else REPLICATED,
        n_real=REPLICATED,
        index=Index(state.index.kind, get_ops(state.index.kind).payload_specs(
            state.index.payload, axis)))
