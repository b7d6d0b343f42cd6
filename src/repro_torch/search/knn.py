"""Brute-force k-NN, masked top-k and recall (port of ``repro.search.knn``).

``topk_smallest`` is the one selection every plain path of the port goes
through. It reproduces ``lax.top_k(-d2, k)`` exactly, ties included: the k
smallest values in ascending order, and among equal values the lower index
first. ``torch.topk`` promises no order on ties, and int8 lookup tables
make exact ties common (every score is an integer sum times one scale per
query), so the ids the port returns depend on this order.
"""
from __future__ import annotations

import torch

__all__ = ["knn_scan", "masked_topk", "recall_at_k", "topk_smallest"]

# rows at most this wide are selected by one stable sort; wider rows (exact
# ground truth over a whole corpus) by torch.topk plus an exact tie repair
_SORT_WIDTH = 4096


def topk_smallest(d2: torch.Tensor, k: int):
    """Row-wise k smallest of ``d2`` (Q, C) as (values ascending, indices
    int64), ties to the lower index — the order of ``lax.top_k(-d2, k)``.
    NaN inputs are not supported. Requires ``k <= C``."""
    nq, c = d2.shape
    if k > c:
        raise ValueError(f"k={k} exceeds the row width {c}")
    if c <= _SORT_WIDTH or 4 * k >= c:
        vals, idx = torch.sort(d2, dim=1, stable=True)
        return vals[:, :k], idx[:, :k]
    # the k-th smallest value bounds the selection: every entry below it
    # is in, and entries equal to it fill the remaining places in index
    # order. Exactly k entries per row are chosen; a stable sort of those
    # k (already in index order) by value gives the lax order.
    kth = torch.topk(d2, k, dim=1, largest=False, sorted=True).values[:, -1:]
    below = d2 < kth
    tied = d2 == kth
    room = k - below.sum(dim=1, keepdim=True)
    chosen = below | (tied & (torch.cumsum(tied, dim=1) <= room))
    slot = torch.cumsum(chosen, dim=1) - 1                # place among chosen
    slot = torch.where(chosen, slot, torch.full_like(slot, k))
    cols = torch.arange(c, device=d2.device).expand(nq, c)
    idx = torch.empty((nq, k + 1), dtype=torch.int64, device=d2.device)
    idx.scatter_(1, slot, cols)                # unchosen land in column k
    idx = idx[:, :k]
    vals = torch.gather(d2, 1, idx)
    vals, order = torch.sort(vals, dim=1, stable=True)
    return vals, torch.gather(idx, 1, order)


def _sq_dists(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    qq = (q * q).sum(dim=-1)[:, None]
    xx = (x * x).sum(dim=-1)[None, :]
    return (qq + xx - 2.0 * (q @ x.T)).clamp_min(0.0)


def knn_scan(q: torch.Tensor, x: torch.Tensor, k: int):
    """Exact k-NN: (dists (Q, k), indices (Q, k)) by L2 distance.

    Tolerates k > N: short rows are right-padded with (inf, -1).
    """
    d2 = _sq_dists(q, x)
    k_eff = min(k, x.shape[0])
    vals, idx = topk_smallest(d2, k_eff)
    if k_eff < k:
        pad = k - k_eff
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return vals.clamp_min(0.0).sqrt(), idx


def masked_topk(d2: torch.Tensor, ids: torch.Tensor, k: int):
    """Row-wise top-k of masked distances carrying payload ids.

    ``d2`` (Q, C) with +inf marking invalid entries; ``ids`` (Q, C) the
    payload. Invalid or missing slots come back as (+inf, -1); tolerates
    k > C by right-padding.
    """
    k_eff = min(k, d2.shape[1])
    vals, sel = topk_smallest(d2, k_eff)
    out_i = torch.where(vals == float("inf"), -1,
                        torch.gather(ids, 1, sel))
    if k_eff < k:
        pad = k - k_eff
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("inf"))
        out_i = torch.nn.functional.pad(out_i, (0, pad), value=-1)
    return vals, out_i


def recall_at_k(found: torch.Tensor, truth: torch.Tensor) -> float:
    """|found ∩ truth| / k per query, averaged. Shapes (Q, k) int."""
    inter = (found[:, :, None] == truth[:, None, :]).any(dim=2)
    return float((inter.sum(dim=1).to(torch.float64)
                  / truth.shape[1]).mean())
