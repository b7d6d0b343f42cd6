"""Mutable serving state: a delta segment, tombstones and compaction over a
frozen base index (port of ``repro.search.segments``).

Layers
------

* **base**: the built index tensors, re-padded to a fixed *row capacity*
  ``n_cap >= N`` (and, for the ivf kinds, per-cell *slack* on the posting
  lists) so compaction appends without changing a shape. ``row_ids
  (n_cap,)`` maps a base row to its external id (-1 = unallocated);
  ``dead (n_cap,) bool`` is the **tombstone bitmap** masking deleted and
  overwritten rows out of every scan.
* **delta**: a fixed-capacity segment of recently upserted rows, scanned
  *exactly* in the scan space. ``delta_ids (cap,)`` holds external ids,
  -1 = empty slot or deletion hole; ``delta_count`` is the append
  pointer.

Quantizers (the Reduce stage and the kind's frozen payload: coarse
centroids, PQ codebooks and their LUT factorization, carried as the
tagged ``Index`` in ``FrozenParams.quant``) are frozen at build time;
compaction codes delta rows against them and never retrains.

Ids are int64, PyTorch's index type (the JAX package's are int32).
``n_rows`` and ``delta_count`` are 0-d int64 tensors on the store's
device, so a write needs no host sync.

Operations:

* ``upsert_fn(store, frozen, ids, vectors)``: tombstone any base copy of
  each id, overwrite the delta slot already holding the id or append a
  new one. The JAX package runs the batch as a sequential scan; this
  version is vectorized and gives the same store: later rows of a batch
  win, a slot already holding the id is overwritten in place, new ids
  take slots in the order of their first row, ``id == -1`` rows are
  no-ops, and rows that find the delta full are counted in ``dropped``.
* ``delete_fn(store, ids)``: tombstone base copies, punch delta holes.
  Deleting an absent id is a no-op.
* ``compact_fn(store, frozen)``: fold the delta into the base: code the
  live delta rows against the frozen quantizers (``IndexOps
  .encode_delta``), append them to the row store and the cell-major
  mirrors, extend the posting lists into their slack (at ``counts[cell]
  + rank``, so the lists stay left-packed), clear the delta.
  All-or-nothing: if the append would overflow the row capacity or a
  cell's slack, the store comes back unchanged with a nonzero
  ``dropped`` and the caller grows it (``grow_store``).

``upsert_fn`` and ``delete_fn`` return new tensors for what they change
and leave their input store as it was. ``compact_fn`` writes the base
tensors of its input store in place (the JAX engine donates the store to
the same effect), so fold a copy when the old store must keep serving.

``rebuild_state`` builds a read-only ``EngineState`` over any row set
with the same frozen quantizers: the from-scratch oracle of the
streaming tests, and what ``SearchEngine.vacuum`` rebuilds from.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .durability.policy import PolicyConfig
from .reducers import Reducer, reduce_vectors, reducer_dim
from .registry import (Index, _pad_cells, _pad_rows, encode_pq, get_ops,
                       ivfpq_encode)
from .tracing import count, span

__all__ = ["StreamConfig", "StreamStore", "MutableEngineState",
           "FrozenParams", "make_mutable", "upsert_fn", "delete_fn",
           "compact_fn", "grow_store", "live_mask", "rebuild_state",
           "encode_pq", "ivfpq_encode"]


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Write-path knobs (``SearchEngine.streaming`` /
    ``ServeConfig.stream`` enable streaming)."""
    delta_capacity: int = 256        # fixed delta segment size (rows)
    compact_threshold: float = 0.75  # auto-compact when the delta holds
    #                                  this fraction of its capacity
    row_capacity: Optional[int] = None   # total base row slots; None =
    #                                      N + 4 * delta_capacity
    cell_slack: Optional[int] = None     # extra posting slots a cell for
    #                                      compaction appends; None =
    #                                      delta_capacity
    write_bucket: int = 64           # min padded write-batch size; ragged
    #                                  batches round up to powers of two
    background_compact: bool = False     # fold a copy on a worker thread
    #                                      while searches keep serving the
    #                                      old store, then swap
    policy: Optional[PolicyConfig] = None    # maintenance thresholds;
    #                                          None = defaults, inactive

    def __post_init__(self):
        if self.delta_capacity < 1:
            raise ValueError("delta_capacity must be >= 1")
        if not (0.0 < self.compact_threshold <= 1.0):
            raise ValueError("compact_threshold must be in (0, 1]")
        if self.cell_slack is not None and self.cell_slack < 1:
            raise ValueError("cell_slack must be >= 1")
        if self.write_bucket < 1:
            raise ValueError("write_bucket must be >= 1")
        if self.policy is not None and not isinstance(self.policy,
                                                      PolicyConfig):
            raise TypeError("StreamConfig.policy must be a repro_torch."
                            "search.durability.PolicyConfig (or None)")


class FrozenParams(NamedTuple):
    """Build-time quantizers shared by base and delta; never written.
    ``quant`` is the tagged union: the kind and its frozen payload (None
    for flat, the coarse centroids for ivf, ``PQQuant`` / ``OPQQuant`` /
    ``IVFPQQuant`` for the coded kinds)."""
    proj: Optional[Reducer]                       # fitted Reduce stage
    quant: Index                                  # kind + frozen quantizers

    @property
    def kind(self) -> str:
        return self.quant.kind

    @property
    def centroids(self) -> Optional[torch.Tensor]:
        q = self.quant.payload
        if self.quant.kind == "ivf":
            return q
        return getattr(q, "centroids", None)

    @property
    def codebooks(self) -> Optional[torch.Tensor]:
        return getattr(self.quant.payload, "codebooks", None)

    @property
    def lut_w(self) -> Optional[torch.Tensor]:
        return getattr(self.quant.payload, "lut_w", None)

    @property
    def cbnorm(self) -> Optional[torch.Tensor]:
        return getattr(self.quant.payload, "cbnorm", None)


class StreamStore(NamedTuple):
    """Every mutable tensor of the streaming engine, fixed shapes.

    Internal id space: base row r in [0, n_cap) | delta slot s as
    ``n_cap + s``. External ids live in ``row_ids`` / ``delta_ids``.
    """
    corpus: torch.Tensor               # (n_cap, D) original-space rows
    row_ids: torch.Tensor              # (n_cap,) int64 row -> external id
    n_rows: torch.Tensor               # () int64 allocated base rows
    dead: torch.Tensor                 # (n_cap,) bool tombstone bitmap
    reduced: Optional[torch.Tensor]    # (n_cap, m) scan-space rows (None:
    #                                    no projection; scan the corpus)
    codes: Optional[torch.Tensor]      # (n_cap, M) uint8 / int32 codes
    bias: Optional[torch.Tensor]       # (n_cap,) f32 ivfpq cross term
    lists: Optional[torch.Tensor]      # (nlist, mc_cap) int64, -1 pads
    codes_cell: Optional[torch.Tensor]  # (nlist, mc_cap, M) cell-major codes
    bias_cell: Optional[torch.Tensor]   # (nlist, mc_cap) cell-major bias
    delta_vectors: torch.Tensor        # (cap, D) original-space delta rows
    delta_reduced: Optional[torch.Tensor]  # (cap, m) scan space (None: no
    #                                        projection)
    delta_ids: torch.Tensor            # (cap,) int64 external ids, -1 empty
    delta_count: torch.Tensor          # () int64 append pointer


# the store is the mutable engine state; the serving layer's name for it
MutableEngineState = StreamStore


def live_mask(store: StreamStore) -> torch.Tensor:
    """(n_cap,) bool: base rows that are allocated and not tombstoned (of
    a store, or of its ``stream.StreamReplica``)."""
    return (store.row_ids >= 0) & ~store.dead


def delta_alive(store: StreamStore) -> torch.Tensor:
    """(cap,) bool: delta slots below the append pointer holding an id (of
    a store, or of its ``stream.StreamReplica``)."""
    cap = store.delta_ids.shape[0]
    slots = torch.arange(cap, device=store.delta_ids.device)
    return (slots < store.delta_count) & (store.delta_ids >= 0)


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.int64).reshape(-1).to(device)


def _isin(elements: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """``torch.isin``, counting the host syncs it makes on the card. ATen
    takes numpy's heuristic: fewer than 10 * numel(elements) ** 0.145 test
    elements are compared one by one, on the device; more take the sorted
    route, whose two ``_unique`` calls read lengths back to the host three
    times on torch 2.11's CUDA build (``set_sync_debug_mode`` counts
    them)."""
    n = elements.numel()
    if n and test.numel() >= int(10.0 * n ** 0.145):
        count("host_syncs", 3)
    return torch.isin(elements, test)


def _tombstone(store: StreamStore, ids: torch.Tensor) -> torch.Tensor:
    """``dead`` with the base copies of the valid ``ids`` marked (pads
    are -1, as unallocated rows are: those never match)."""
    return store.dead | (_isin(store.row_ids, ids) & (store.row_ids >= 0))


def make_mutable(state, config: StreamConfig
                 ) -> Tuple[StreamStore, FrozenParams]:
    """Re-lay a read-only ``EngineState`` into (StreamStore,
    FrozenParams). Every store tensor is a fresh buffer (padded or
    copied, ``IndexOps.store_parts`` laying out the kind's base), so the
    store never aliases the state it came from; the frozen quantizers
    do."""
    kind = state.index.kind
    ops = get_ops(kind)
    n, d = state.corpus.shape
    dev = state.corpus.device
    cap = config.delta_capacity
    n_cap = config.row_capacity or n + 4 * cap
    if n_cap <= n:
        raise ValueError(
            f"row_capacity {n_cap} must exceed the corpus size {n} "
            "(compaction needs append slack)")
    proj = state.proj
    slack = config.cell_slack if config.cell_slack is not None else cap
    parts, quant = ops.store_parts(state, n_cap, slack)
    m_dim = reducer_dim(proj) if proj is not None else d
    store = StreamStore(
        corpus=_pad_rows(state.corpus, n_cap),
        row_ids=_pad_rows(torch.arange(n, device=dev), n_cap, fill=-1),
        n_rows=torch.tensor(n, dtype=torch.int64, device=dev),
        dead=torch.zeros(n_cap, dtype=torch.bool, device=dev),
        reduced=parts.get("reduced"), codes=parts.get("codes"),
        bias=parts.get("bias"), lists=parts.get("lists"),
        codes_cell=parts.get("codes_cell"), bias_cell=parts.get("bias_cell"),
        delta_vectors=torch.zeros((cap, d), dtype=torch.float32, device=dev),
        delta_reduced=(torch.zeros((cap, m_dim), dtype=torch.float32,
                                   device=dev) if proj is not None else None),
        delta_ids=torch.full((cap,), -1, dtype=torch.int64, device=dev),
        delta_count=torch.zeros((), dtype=torch.int64, device=dev))
    return store, FrozenParams(proj=proj, quant=Index(kind, quant))


# --- the write path ----------------------------------------------------------

def _set_rows(buf: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor,
              write: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` with ``rows[i]`` at ``slot[i]`` where ``write[i]``;
    the other rows land on a scratch row past the end, dropped."""
    cap = buf.shape[0]
    out = torch.cat([buf, buf.new_zeros((1,) + tuple(buf.shape[1:]))])
    out[torch.where(write, slot, cap)] = rows.to(buf.dtype)
    return out[:cap]


def upsert_fn(store: StreamStore, frozen: FrozenParams, ids, vectors
              ) -> Tuple[StreamStore, torch.Tensor]:
    """Apply a padded upsert batch (ids (B,) with -1 = no-op pad, vectors
    (B, D)) as the rows in order would, later rows winning.

    Returns (store, dropped): ``dropped`` (a 0-d tensor) counts valid rows
    that found the delta full (the engine compacts first, so it stays 0;
    direct callers check it, compact and retry the rest).
    """
    dev = store.delta_ids.device
    ids = _ids(ids, dev)
    vectors = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
    vectors = vectors.reshape(ids.shape[0], -1)
    b = ids.shape[0]
    cap = store.delta_ids.shape[0]
    valid = ids >= 0
    rows = torch.arange(b, device=dev)
    slots = torch.arange(cap, device=dev)
    # the batch's first and last row of each id
    same = (ids[:, None] == ids[None, :]) & valid[:, None] & valid[None, :]
    first = torch.where(same, rows[None, :], b).amin(dim=1)
    last = torch.where(same, rows[None, :], -1).amax(dim=1)
    # a live delta slot already holding the id (ids are unique there)
    held = ((store.delta_ids[None, :] == ids[:, None])
            & (slots < store.delta_count)[None, :] & valid[:, None])
    exists = held.any(dim=1)
    old_slot = torch.where(held, slots[None, :], cap).amin(dim=1)
    # a new id takes the next slot in the order of its first row
    opens = valid & ~exists & (first == rows)
    rank = torch.cumsum(opens.to(torch.int64), dim=0) - 1
    new_slot = store.delta_count + rank[first.clamp(max=b - 1)]
    slot = torch.where(exists, old_slot, new_slot)
    fits = valid & (slot < cap)
    dropped = (valid & ~fits).sum()
    write = fits & (last == rows)
    red = (reduce_vectors(frozen.proj, vectors)
           if store.delta_reduced is not None else None)
    with span("write.tombstone"):
        dead = _tombstone(store, ids)
    out = store._replace(
        dead=dead,
        delta_ids=_set_rows(store.delta_ids, slot, ids, write),
        delta_vectors=_set_rows(store.delta_vectors, slot, vectors, write),
        delta_reduced=(_set_rows(store.delta_reduced, slot, red, write)
                       if red is not None else None),
        delta_count=store.delta_count + (opens & fits).sum())
    return out, dropped


def delete_fn(store: StreamStore, ids) -> StreamStore:
    """Apply a padded delete batch (ids (B,), -1 = no-op pad): tombstone
    base rows, punch delta holes. Absent ids are no-ops."""
    ids = _ids(ids, store.delta_ids.device)
    with span("write.tombstone"):
        kill = _isin(store.delta_ids, ids) & (store.delta_ids >= 0)
        dead = _tombstone(store, ids)
    return store._replace(dead=dead,
                          delta_ids=torch.where(kill, -1, store.delta_ids))


def compact_fn(store: StreamStore, frozen: FrozenParams
               ) -> Tuple[StreamStore, torch.Tensor]:
    """Fold the delta segment into the base; returns (store, dropped).

    All-or-nothing: when the append would overflow the row capacity or a
    posting cell's slack, ``store`` comes back unchanged and ``dropped``
    (the rows that could not be folded) is nonzero; grow the store and
    retry. Otherwise the base tensors of ``store`` are written in place.
    One host sync decides which.
    """
    ops = get_ops(frozen.quant.kind)
    n_cap = store.corpus.shape[0]
    alive = delta_alive(store)
    pos = torch.cumsum(alive.to(torch.int64), dim=0) - 1    # packed ordinal
    n_alive = alive.sum()
    ok = store.n_rows + n_alive <= n_cap
    scan_rows = (store.delta_reduced if store.delta_reduced is not None
                 else store.delta_vectors)
    assign, codes, bias = ops.encode_delta(frozen, scan_rows)
    slot_pos = None
    if store.lists is not None:
        nlist, mc_cap = store.lists.shape
        counts = (store.lists >= 0).sum(dim=1)
        onehot = (torch.nn.functional.one_hot(assign, nlist)
                  * alive[:, None].to(torch.int64))
        rank = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                            assign[:, None])[:, 0]
        slot_pos = counts[assign] + rank
        ok = ok & ~(alive & (slot_pos >= mc_cap)).any()
    count("host_syncs")
    if not bool(ok):
        return store, n_alive
    count("host_syncs")               # nonzero reads its length back
    src = alive.nonzero()[:, 0]
    dest = store.n_rows + pos[src]
    store.corpus[dest] = store.delta_vectors[src]
    store.row_ids[dest] = store.delta_ids[src]
    if store.reduced is not None:
        store.reduced[dest] = store.delta_reduced[src]
    if store.codes is not None:
        store.codes[dest] = codes[src].to(store.codes.dtype)
    if store.bias is not None:
        store.bias[dest] = bias[src]
    if store.lists is not None:
        cell, at = assign[src], slot_pos[src]
        store.lists[cell, at] = dest
        if store.codes_cell is not None:
            store.codes_cell[cell, at] = codes[src].to(store.codes_cell.dtype)
            store.bias_cell[cell, at] = bias[src]
    out = store._replace(
        n_rows=store.n_rows + n_alive,
        delta_ids=torch.full_like(store.delta_ids, -1),
        delta_count=torch.zeros_like(store.delta_count))
    return out, torch.zeros_like(n_alive)


def grow_store(store: StreamStore, *, row_extra: int = 0,
               cell_extra: int = 0) -> StreamStore:
    """Capacity growth (the compaction-overflow escape hatch): pad the row
    store by ``row_extra`` rows and every posting cell by ``cell_extra``
    slots."""
    n_cap = store.corpus.shape[0] + row_extra

    def rows(a, fill=0):
        return _pad_rows(a, n_cap, fill) if a is not None else None

    def cells(a, fill=0):
        return _pad_cells(a, cell_extra, fill) if a is not None else None

    return store._replace(
        corpus=rows(store.corpus), row_ids=rows(store.row_ids, -1),
        dead=rows(store.dead, False), reduced=rows(store.reduced),
        codes=rows(store.codes), bias=rows(store.bias),
        lists=cells(store.lists, -1), codes_cell=cells(store.codes_cell),
        bias_cell=cells(store.bias_cell))


def rebuild_state(frozen: FrozenParams, vectors, *,
                  index: Optional[str] = None, shards: int = 1):
    """A read-only ``EngineState`` over ``vectors`` with the FROZEN
    quantizers (no retraining): the offline full rebuild, and the oracle
    the streaming engine must equal after ``compact()``. ``index``
    defaults to the frozen kind; ``shards`` pads the ivf kinds' cell axis
    to a multiple of the shard count (``ivf.posting_lists``). ``vectors``
    go to the frozen quantizers' device."""
    from .serve import EngineState

    kind = index if index is not None else frozen.quant.kind
    if kind != frozen.quant.kind:
        raise ValueError(f"index={kind!r} does not match the frozen "
                         f"quantizers ({frozen.quant.kind!r})")
    vectors = torch.as_tensor(vectors, dtype=torch.float32)
    dev = _device(frozen)
    if dev is not None:
        vectors = vectors.to(dev)
    reduced = reduce_vectors(frozen.proj, vectors)
    payload = get_ops(kind).rebuild(frozen, reduced, shards)
    return EngineState(corpus=vectors, proj=frozen.proj,
                       index=Index(kind, payload))


def _device(frozen: FrozenParams) -> Optional[torch.device]:
    from repro_torch._tree import tree_leaves
    for leaf in tree_leaves((frozen.proj.params if frozen.proj is not None
                             else None, frozen.quant.payload)):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None
