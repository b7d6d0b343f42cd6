"""Streaming search over a base index, a delta segment and tombstones
(port of ``repro.search.stream``).

``stream_search_fn`` is the mutable engine's counterpart of
``repro_torch.search.serve.search_fn``: the same project -> scan ->
re-rank pipeline, extended with

* a **tombstone mask** (``live = row_ids >= 0 & ~dead``) applied before
  every base top-k, so dead rows never crowd live candidates out of the
  budget (``IndexOps.stream_scan`` of the frozen kind; for ivfpq the
  mask rides the candidate ids, which K1's cell-major entry reads);
* an **exact delta scan**: recently upserted rows are scored with true
  squared distances in the scan space, plain torch as in the JAX package;
* a merge of the two layers in one internal id space (base row r | delta
  slot ``n_cap + s``), the dedup'd exact re-rank with a two-source
  gather, and a final map from internal ids to external ids.

``sharded_stream_search_fn`` runs the same pipeline with the base split
over the ranks of a mesh (``repro_torch.parallel.engine.shard_stream``):
the delta segment, the tombstones and the id maps are replicated, taken
from each rank's own store (``StreamReplica``), so writes touch only
those and the sharded base stays valid between compactions. Each rank
scans its base block with the replicated ``live`` mask
(``IndexOps.local_scan``); the ranks' lists are merged, every rank scans
the delta alike, and the two-source re-rank scores base rows on their
owner and delta rows everywhere, a MIN all-reduce assembling the row.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.parallel.context import Mesh, all_reduce_min, require_mesh

from .knn import _sq_dists, masked_topk, topk_smallest
from .pq import _check_adc_args
from .reducers import reduce_vectors
from .registry import ScanParams, get_ops
from .segments import FrozenParams, StreamStore, delta_alive, live_mask
from .serve import (ShardedEngineState, _check_axis, _check_rerank_budget,
                    _dedupe_candidates, _merge_local)
from .tracing import span

__all__ = ["stream_search_fn", "sharded_stream_search_fn", "StreamReplica",
           "replica_from_store"]


class StreamReplica(NamedTuple):
    """The replicated, write-hot tensors a sharded streaming search needs
    beside the sharded base: the id maps, the tombstones and the delta
    segment. Taken from the ``StreamStore`` for every call, so upserts and
    deletes never touch the sharded base."""
    row_ids: torch.Tensor                   # (n_cap,)
    dead: torch.Tensor                      # (n_cap,) bool
    delta_vectors: torch.Tensor             # (cap, D)
    delta_reduced: Optional[torch.Tensor]   # (cap, m)
    delta_ids: torch.Tensor                 # (cap,)
    delta_count: torch.Tensor               # ()


def replica_from_store(store: StreamStore) -> StreamReplica:
    """The write-hot replicated tensors of a ``StreamStore`` (the same
    tensors, no copy; fresh every call so the sharded read path serves the
    latest writes)."""
    return StreamReplica(
        row_ids=store.row_ids, dead=store.dead,
        delta_vectors=store.delta_vectors, delta_reduced=store.delta_reduced,
        delta_ids=store.delta_ids, delta_count=store.delta_count)


def _check_stream_backend(kind: str, backend: str):
    if kind in ("pq", "opq") and backend == "kernel":
        raise ValueError(
            f"streaming index={kind!r} needs backend='jnp': the "
            "shared-codes kernel (K2) has no masked entry point for an "
            "arbitrary tombstone bitmap (ivfpq folds the mask into its "
            "candidate ids)")


def _delta_scan(qr, delta_scan_rows, alive, n_cap, n_cand):
    """Exact scan of the delta segment in the scan space; internal ids are
    offset by ``n_cap``. Empty and hole slots mask to (+inf, -1)."""
    cap = alive.shape[0]
    d2 = torch.where(alive[None, :], _sq_dists(qr, delta_scan_rows),
                     float("inf"))
    ids = (n_cap + torch.arange(cap, device=qr.device)).expand(
        qr.shape[0], cap)
    return masked_topk(d2, ids, min(n_cand, cap))


def _stream_rerank(queries, corpus, delta_vectors, cand, k):
    """``exact_rerank`` with the two-source gather: internal ids below
    ``n_cap`` read base corpus rows, the rest delta rows. Returns (dists
    (Q, k), INTERNAL ids (Q, k))."""
    cand, valid = _dedupe_candidates(cand)
    n_cap, cap = corpus.shape[0], delta_vectors.shape[0]
    isd = cand >= n_cap
    bv = corpus[cand.clamp(0, n_cap - 1)]
    dv = delta_vectors[(cand - n_cap).clamp(0, cap - 1)]
    cv = torch.where(isd[..., None], dv, bv)
    d2 = ((cv - queries[:, None, :]) ** 2).sum(dim=-1)
    d2 = torch.where(valid, d2, float("inf"))
    vals, sel = topk_smallest(d2, k)
    return vals.clamp_min(0.0).sqrt(), torch.gather(cand, 1, sel)


def _to_external(ids, row_ids, delta_ids):
    """Internal (base row | n_cap + slot) -> external ids; -1 pads kept."""
    n_cap, cap = row_ids.shape[0], delta_ids.shape[0]
    ext_b = row_ids[ids.clamp(0, n_cap - 1)]
    ext_d = delta_ids[(ids - n_cap).clamp(0, cap - 1)]
    ext = torch.where(ids >= n_cap, ext_d, ext_b)
    return torch.where(ids >= 0, ext, -1)


def stream_search_fn(store: StreamStore, frozen: FrozenParams,
                     queries: torch.Tensor, k: int, *,
                     nprobe: int = 8, rerank: int = 64, backend: str = "jnp",
                     lut_dtype: str = "f32", scan_cap: int = 0,
                     prefilter: int = 0):
    """The mutable engine's query pipeline: project -> tombstone-masked
    base scan -> exact delta scan -> merged top-C -> two-source exact
    re-rank -> external ids. Returns (dists (Q, k), external ids (Q, k));
    -1 ids pad short rows."""
    if scan_cap or prefilter:
        raise ValueError(
            "scan_cap/prefilter are read-only fast paths: the compact "
            "scan's posting-mass cap goes stale under writes and the "
            "pre-filter bounds ignore tombstones; leave both 0 on the "
            "streaming path")
    kind = frozen.quant.kind
    ops = get_ops(kind)
    _check_adc_args(backend, lut_dtype)
    _check_stream_backend(kind, backend)
    with span("search.project"):
        queries = queries.to(torch.float32)
        qr = reduce_vectors(frozen.proj, queries)
    approximate = frozen.proj is not None or ops.lossy
    _check_rerank_budget(approximate, rerank, k)
    n_cand = rerank if approximate else k
    n_cap = store.corpus.shape[0]
    p = ScanParams(nprobe=nprobe, backend=backend, lut_dtype=lut_dtype)
    with span("search.live_map"):
        live = live_mask(store)
    # the kind's scan opens search.probe / search.live_map / search.scan
    bd2, bids = ops.stream_scan(store, frozen, qr, n_cand, live, p)
    with span("search.delta_scan"):
        delta_rows = (store.delta_reduced if store.delta_reduced is not None
                      else store.delta_vectors)
        dd2, dids = _delta_scan(qr, delta_rows, delta_alive(store), n_cap,
                                n_cand)
    with span("search.merge"):
        _, mids = masked_topk(torch.cat([bd2, dd2], dim=1),
                              torch.cat([bids, dids], dim=1), n_cand)
    with span("search.rerank"):
        dists, internal = _stream_rerank(queries, store.corpus,
                                         store.delta_vectors, mids, k)
        return dists, _to_external(internal, store.row_ids,
                                   store.delta_ids)


# --- sharded streaming (base sharded, delta and tombstones replicated) ------

def sharded_stream_search_fn(sbase: ShardedEngineState, repl: StreamReplica,
                             queries: torch.Tensor, k: int, *,
                             mesh: Optional[Mesh] = None, axis: str = "data",
                             nprobe: int = 8, rerank: int = 64,
                             backend: str = "jnp", lut_dtype: str = "f32",
                             scan_cap: int = 0, prefilter: int = 0):
    """``stream_search_fn`` with the base split over the ``axis`` of
    ``mesh`` (default: the context's mesh); every rank calls it on its
    own base block with the same replica and queries.

    Each rank's masked base scan keeps a full local top-n_cand, so the
    merged base candidate set is the single-device one, and the delta
    scan is the same on every rank: the results are the single-device
    streaming search's, on every rank. Returns (dists (Q, k), external
    ids (Q, k))."""
    if mesh is None:
        mesh = require_mesh("sharded_stream_search_fn")
    _check_axis(mesh, axis)
    if scan_cap or prefilter:
        raise ValueError(
            "scan_cap/prefilter are single-device read-only fast paths; "
            "leave both 0 on the sharded streaming path")
    kind = sbase.index.kind
    ops = get_ops(kind)
    _check_adc_args(backend, lut_dtype)
    _check_stream_backend(kind, backend)
    queries = queries.to(torch.float32)
    qr = reduce_vectors(sbase.proj, queries)
    approximate = sbase.proj is not None or ops.lossy
    _check_rerank_budget(approximate, rerank, k)
    n_cand = rerank if approximate else k
    live = live_mask(repl)
    n_cap = repl.row_ids.shape[0]
    p = ScanParams(nprobe=nprobe, backend=backend, lut_dtype=lut_dtype)
    d2, cand = ops.local_scan(sbase, qr, n_cand, p, mesh.rank, 0, live=live)
    bd2, bids = _merge_local(mesh, d2, cand, n_cand)
    cap = repl.delta_ids.shape[0]
    delta_rows = (repl.delta_reduced if repl.delta_reduced is not None
                  else repl.delta_vectors)
    dd2, dids = _delta_scan(qr, delta_rows, delta_alive(repl), n_cap,
                            n_cand)
    _, mids = masked_topk(torch.cat([bd2, dd2], dim=1),
                          torch.cat([bids, dids], dim=1), n_cand)
    # the two-source re-rank: base rows scored by their owner, delta rows
    # alike on every rank; the MIN all-reduce assembles the row
    cand2, valid = _dedupe_candidates(mids)
    n_loc = sbase.corpus.shape[0]
    isd = cand2 >= n_cap
    local = cand2 - mesh.rank * n_loc
    own_base = valid & ~isd & (local >= 0) & (local < n_loc)
    bv = sbase.corpus[local.clamp(0, n_loc - 1)]
    dv = repl.delta_vectors[(cand2 - n_cap).clamp(0, cap - 1)]
    cv = torch.where(isd[..., None], dv, bv)
    d2 = ((cv - queries[:, None, :]) ** 2).sum(dim=-1)
    d2 = all_reduce_min(mesh, torch.where(own_base | (valid & isd), d2,
                                          float("inf")))
    vals, sel = topk_smallest(d2, k)
    internal = torch.gather(cand2, 1, sel)
    internal = torch.where(vals == float("inf"), -1, internal)
    return (vals.clamp_min(0.0).sqrt(),
            _to_external(internal, repl.row_ids, repl.delta_ids))
