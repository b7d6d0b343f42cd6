"""Coarse k-means quantizer and posting lists (port of the parts of
``repro.search.ivf`` the IVF-PQ path uses).

Posting lists are padded-dense: a (nlist, max_cell) id matrix with -1
pads, so the probe is a gather plus a masked top-k. Ids and lists are
int64, PyTorch's index type.
"""
from __future__ import annotations

from typing import Optional

import torch

from .knn import topk_smallest

__all__ = ["sq_dists", "nearest", "kmeans", "posting_lists", "probe_cells"]

# rows of ``x`` per distance block in ``nearest``: bounds the (rows, nlist)
# distance matrix at 1M x 1024 scale to 256 MB
_ASSIGN_ROWS = 65536


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unclamped pairwise squared L2: |a|^2 + |b|^2 - 2 a@b^T, shape (A, B)."""
    return ((a * a).sum(dim=1)[:, None] + (b * b).sum(dim=1)[None, :]
            - 2.0 * a @ b.T)


def nearest(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """argmin_j sq_dists(x, cent)[i, j] per row (first index on ties), in
    row blocks so the distance matrix never has to exist whole."""
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], _ASSIGN_ROWS):
        out[s:s + _ASSIGN_ROWS] = sq_dists(x[s:s + _ASSIGN_ROWS],
                                           cent).argmin(dim=1)
    return out


def kmeans(x: torch.Tensor, nlist: int, iters: int = 12, *,
           init: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Lloyd k-means; an empty cluster keeps its old centroid.

    ``init`` (nlist,) row indices of the starting centroids; without it
    ``nlist`` distinct rows are drawn from ``generator`` (the JAX version
    draws them with ``jax.random.choice(key, n, (nlist,), replace=False)``).
    Cluster sums use ``index_add_`` instead of JAX's (N, nlist) one-hot
    matmul, which at 1M x 1024 would be 4 GB.
    """
    n = x.shape[0]
    if init is None:
        init = torch.randperm(n, generator=generator)[:nlist]
    cent = x[torch.as_tensor(init, dtype=torch.int64).to(x.device)]
    for _ in range(iters):
        assign = nearest(x, cent)
        counts = torch.bincount(assign, minlength=nlist).to(x.dtype)
        sums = torch.zeros_like(cent).index_add_(0, assign, x)
        new = sums / counts.clamp_min(1.0)[:, None]
        cent = torch.where((counts > 0)[:, None], new, cent)
    return cent


def posting_lists(assign: torch.Tensor, nlist: int) -> torch.Tensor:
    """Padded-dense posting lists from a cell assignment: (nlist, max_cell)
    int64 ids, -1 = pad; each row holds its ids ascending, then pads."""
    counts = torch.bincount(assign, minlength=nlist)
    max_cell = int(counts.max())
    order = torch.argsort(assign, stable=True)
    sorted_cells = assign[order]
    # position of each sorted element within its cell
    pos = (torch.arange(order.shape[0], device=assign.device)
           - torch.searchsorted(sorted_cells, sorted_cells, side="left"))
    lists = torch.full((nlist, max_cell), -1, dtype=torch.int64,
                       device=assign.device)
    lists[sorted_cells, pos] = order
    return lists


def probe_cells(centroids: torch.Tensor, lists: torch.Tensor,
                q: torch.Tensor, nprobe: int, min_cand: int):
    """The nearest ``nprobe`` cells' posting lists.

    Returns (probe (Q, nprobe) cell ids, cand (Q, C) ids with -1 pads,
    coarse d2 (Q, nprobe) in probe order); ``cand`` is right-padded with -1
    up to ``min_cand``.
    """
    cd2 = sq_dists(q, centroids)                          # (Q, nlist)
    cd2p, probe = topk_smallest(cd2, nprobe)              # (Q, nprobe)
    cand = lists[probe].reshape(q.shape[0], -1)
    if cand.shape[1] < min_cand:
        cand = torch.nn.functional.pad(cand, (0, min_cand - cand.shape[1]),
                                       value=-1)
    return probe, cand, cd2p
