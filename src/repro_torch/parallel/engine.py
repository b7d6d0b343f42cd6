"""``shard_engine``: this rank's part of a serving ``EngineState`` (port of
``repro.parallel.engine``).

The layout pass of sharded serving, one slice of the database axis a
rank. The per-kind layout is a registry hook (``IndexOps.shard_payload``,
pure padding), split by the leaves' markers (``engine_state_specs``):

* **row-split leaves** (corpus rows, flat scan vectors, plain-PQ and OPQ
  codes) are padded to a multiple of the shard count and cut into
  per-rank blocks along dim 0 (pad rows carry global ids >= ``n_real``
  and are masked out of every scan);
* **cell-split leaves** (IVF / IVF-PQ posting lists, the ``codes_cell`` /
  ``bias_cell`` mirrors and IVF's ``cell_vecs``) are padded with empty
  (-1) cells and cut along the cell axis;
* everything else (projection, coarse centroids, codebooks and their
  table factorization) is replicated, so the probe and the tables are
  the same on every rank.

Every rank runs it on the same dense state (built, or restored, alike)
and keeps its own block. The result is a ``ShardedEngineState`` for
``sharded_search_fn`` / ``SearchEngine.shard``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.search.registry import Index, _pad_dim0, get_ops
from repro_torch.search.serve import EngineState, ShardedEngineState

from .context import Mesh, require_mesh
from .sharding import engine_state_specs, rank_block

__all__ = ["shard_engine", "shard_stream"]


def shard_engine(state: EngineState, mesh: Optional[Mesh] = None,
                 axis: str = "data", donate: bool = False,
                 keep=()) -> ShardedEngineState:
    """This rank's part of ``state`` laid out over the ``axis`` of ``mesh``
    (default: the context's mesh). Pure layout, no index rebuild: the
    ranks' blocks together hold the same rows, posting lists and codes,
    so ``sharded_search_fn`` returns what ``search_fn`` returns on
    ``state``.

    ``donate=True`` frees the dense tensors once this rank's block is
    taken (build -> shard -> serve without a second copy of the
    database): every tensor of ``state`` that did not pass into the
    result unchanged is emptied (``Tensor.set_()``, so it frees its
    memory even while the caller holds it), except those listed in
    ``keep`` (by identity, e.g. a corpus the caller owns). The caller
    drops its own references to ``state``.
    """
    if mesh is None:
        mesh = require_mesh("shard_engine")
    sharded, padded = _layout(state, mesh, axis, copy=False)
    if donate:
        hold = {id(t) for t in _tensors(sharded)} | {id(t) for t in keep}
        with torch.no_grad():
            for t in _tensors(state) + _tensors(padded):
                if id(t) not in hold:
                    t.set_()
    return sharded


def _layout(state: EngineState, mesh: Mesh, axis: str, copy: bool):
    """(this rank's ``ShardedEngineState``, the padded whole one): the
    kind's padding, then each split leaf cut to this rank's block
    (``rank_block``; ``copy`` copies a split leaf on a mesh of one rank
    too)."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh has axis {mesh.axis!r}, not {axis!r}")
    shards = mesh.size
    payload = get_ops(state.index.kind).shard_payload(state, shards)
    padded = ShardedEngineState(
        corpus=_pad_dim0(state.corpus, shards), proj=state.proj,
        n_real=int(state.corpus.shape[0]),
        index=Index(state.index.kind, payload))
    specs = engine_state_specs(padded, axis)

    def block(leaf, marker):
        return rank_block(mesh, leaf, marker, copy=copy)

    sharded = ShardedEngineState(
        corpus=block(padded.corpus, specs.corpus), proj=padded.proj,
        n_real=padded.n_real,
        index=Index(padded.index.kind, tree_map(block, payload,
                                                specs.index.payload)))
    return sharded, padded


def _tensors(tree) -> list:
    """Every tensor of an engine state, the reducer's params and the
    payload included."""
    proj = tree.proj.params if tree.proj is not None else None
    return [t for t in tree_leaves((tree.corpus, proj, tree.index.payload))
            if isinstance(t, torch.Tensor)]


def shard_stream(store, frozen, mesh: Optional[Mesh] = None,
                 axis: str = "data") -> ShardedEngineState:
    """This rank's part of a streaming engine's **base** over ``mesh``.

    The store's base tensors (capacity-padded rows, posting lists, codes)
    are laid out as a read-only engine's, ``n_real`` being the row
    capacity (allocation and tombstones live in the replicated ``live``
    mask the streaming search passes to the local scans). The delta
    segment, the tombstones and the id maps stay with the store
    (``repro_torch.search.stream.StreamReplica``). Never donates: the
    store backs the write path, and compaction writes its base tensors in
    place, so every split leaf is this rank's own copy, on a mesh of one
    rank too (the kinds' ``IndexOps.stream_base_payload`` hand over the
    store's tensors; the whole base is never copied)."""
    if mesh is None:
        mesh = require_mesh("shard_stream")
    kind = frozen.quant.kind
    payload = get_ops(kind).stream_base_payload(store, frozen, store.corpus)
    base = EngineState(corpus=store.corpus, proj=frozen.proj,
                       index=Index(kind, payload))
    return _layout(base, mesh, axis, copy=True)[0]
