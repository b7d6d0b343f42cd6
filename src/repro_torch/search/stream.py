"""Streaming search over a base index, a delta segment and tombstones
(port of the single-device half of ``repro.search.stream``).

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

Not ported yet (ROADMAP.md, item 11): ``sharded_stream_search_fn``,
``StreamReplica`` and ``replica_from_store``.
"""
from __future__ import annotations

import torch

from .knn import _sq_dists, masked_topk, topk_smallest
from .pq import _check_adc_args
from .reducers import reduce_vectors
from .registry import ScanParams, get_ops
from .segments import FrozenParams, StreamStore, delta_alive, live_mask
from .serve import _check_rerank_budget, _dedupe_candidates

__all__ = ["stream_search_fn"]


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
    queries = queries.to(torch.float32)
    qr = reduce_vectors(frozen.proj, queries)
    approximate = frozen.proj is not None or ops.lossy
    _check_rerank_budget(approximate, rerank, k)
    n_cand = rerank if approximate else k
    n_cap = store.corpus.shape[0]
    p = ScanParams(nprobe=nprobe, backend=backend, lut_dtype=lut_dtype)
    bd2, bids = ops.stream_scan(store, frozen, qr, n_cand, live_mask(store),
                                p)
    delta_rows = (store.delta_reduced if store.delta_reduced is not None
                  else store.delta_vectors)
    dd2, dids = _delta_scan(qr, delta_rows, delta_alive(store), n_cap,
                            n_cand)
    _, mids = masked_topk(torch.cat([bd2, dd2], dim=1),
                          torch.cat([bids, dids], dim=1), n_cand)
    dists, internal = _stream_rerank(queries, store.corpus,
                                     store.delta_vectors, mids, k)
    return dists, _to_external(internal, store.row_ids, store.delta_ids)
