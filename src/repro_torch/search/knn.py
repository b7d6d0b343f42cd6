"""Brute-force k-NN, masked top-k, recall and the paper's A_m(k) metric
(port of ``repro.search.knn``).

On a CUDA tensor every exact search (``knn_scan``, ``knn_search``,
``knn_search_blocked``, and so ``amk_accuracy``) runs kernel K3
(``repro_torch.kernels.knn_topk``), which launches or raises; on the CPU
each keeps its plain form, the blocked scan's running merge included.

``topk_smallest`` is the one selection every plain path of the port goes
through. It reproduces ``lax.top_k(-d2, k)`` exactly, ties included: the k
smallest values in ascending order, and among equal values the lower index
first. ``torch.topk`` promises no order on ties, and int8 lookup tables
make exact ties common (every score is an integer sum times one scale per
query), so the ids the port returns depend on this order.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["knn_scan", "knn_search", "knn_search_blocked", "masked_topk",
           "recall_at_k", "amk_accuracy", "topk_smallest"]

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


def _k3():
    # imported at the first call: the kernel's plain version imports
    # ``topk_smallest`` from this module
    from repro_torch.kernels.knn_topk import ops
    return ops


def knn_scan(q: torch.Tensor, x: torch.Tensor, k: int):
    """Exact k-NN: (dists (Q, k), indices (Q, k)) by L2 distance.

    Tolerates k > N: short rows are right-padded with (inf, -1). On a CUDA
    tensor this is kernel K3, for any k.
    """
    if q.device.type == "cuda":
        d2, idx = _k3().knn_topk_d2(q.contiguous(), x.contiguous(), k)
        return d2.sqrt(), idx
    d2 = _sq_dists(q, x)
    k_eff = min(k, x.shape[0])
    vals, idx = topk_smallest(d2, k_eff)
    if k_eff < k:
        pad = k - k_eff
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return vals.clamp_min(0.0).sqrt(), idx


def knn_search(q: torch.Tensor, x: torch.Tensor, k: int):
    """Exact k-NN: returns (dists (Q, k), indices (Q, k)) by L2 distance
    (``knn_scan``)."""
    return knn_scan(q, x, k)


def knn_search_blocked(q: torch.Tensor, x: torch.Tensor, k: int,
                       block: int = 1024):
    """Streaming exact k-NN with a running top-k over database blocks.

    The database is padded with +inf rows to whole blocks and the running
    list starts at (inf, 0), so where fewer than k rows exist the slots
    pad with (inf, 0), as in the JAX version. On a CUDA tensor this is
    kernel K3 (which needs no blocks; ``block`` shapes the CPU scan only).
    """
    if q.device.type == "cuda":
        d2, idx = _k3().knn_topk_d2(q.contiguous(), x.contiguous(), k)
        return d2.sqrt(), idx.clamp_min(0)
    nq, n = q.shape[0], x.shape[0]
    pad = (-n) % block
    if pad:
        x = torch.cat([x, x.new_full((pad, x.shape[1]), float("inf"))])
    qq = (q * q).sum(dim=-1)[:, None]
    best_d = torch.full((nq, k), float("inf"), dtype=q.dtype,
                        device=q.device)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=q.device)
    cols = torch.arange(block, device=q.device)
    for off in range(0, x.shape[0], block):
        xblk = x[off:off + block]
        xx = (xblk * xblk).sum(dim=-1)[None, :]
        d2 = qq + xx - 2.0 * (q @ xblk.T)                 # (Q, block)
        # the padding rows make q @ inf, NaN where q has a zero: masked
        d2 = torch.where(torch.isfinite(xx), d2.clamp_min(0.0),
                         float("inf"))
        cand_d = torch.cat([best_d, d2], dim=1)
        cand_i = torch.cat([best_i, (off + cols).expand(nq, block)], dim=1)
        best_d, sel = topk_smallest(cand_d, k)
        best_i = torch.gather(cand_i, 1, sel)
    return best_d.clamp_min(0.0).sqrt(), best_i


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


def amk_accuracy(reducer, x_train: torch.Tensor, y_test: torch.Tensor,
                 k: int, block=None) -> float:
    """The paper's A_m(k) (Section 3.2).

    For each test vector y_i: k-NN in the *original* space X vs k-NN of
    f(y_i) in the *reduced* set f(X); A_m(k) = mean fraction retained.
    ``reducer`` is a callable or has a ``.transform``. On CUDA tensors both
    searches run kernel K3.
    """
    if block is None:
        search = knn_search
    else:
        search = functools.partial(knn_search_blocked, block=block)
    _, truth = search(y_test, x_train, k)
    apply = reducer if callable(reducer) else reducer.transform
    xr = apply(x_train).to(torch.float32)
    yr = apply(y_test).to(torch.float32)
    _, found = search(yr, xr, k)
    return recall_at_k(found, truth)
