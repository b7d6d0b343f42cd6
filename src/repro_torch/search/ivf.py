"""IVF-Flat: the coarse k-means quantizer, posting lists and the probed
exact scan (port of ``repro.search.ivf``, single-device part).

Posting lists are padded-dense: a (nlist, max_cell) id matrix with -1
pads, so the probe is a gather plus a masked top-k. Ids and lists are
int64, PyTorch's index type. The ivf scan has no kernel behind it, in
the JAX package either: a gather of the probed rows and a top-k.

Not ported yet (ROADMAP.md, item 11): ``balance_cells``, the ``shards=``
layouts and ``ivf_local_scan``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._segment import segment_sum

from .knn import topk_smallest

__all__ = ["IVFIndex", "sq_dists", "nearest", "kmeans", "posting_lists",
           "probe_cells", "build_ivf", "cell_vectors", "ivf_scan",
           "ivf_search"]

# rows of ``x`` per distance block in ``nearest``: bounds the (rows, nlist)
# distance matrix at 1M x 1024 scale to 256 MB
_ASSIGN_ROWS = 65536


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unclamped pairwise squared L2: |a|^2 + |b|^2 - 2 a@b^T, shape (A, B)."""
    return ((a * a).sum(dim=1)[:, None] + (b * b).sum(dim=1)[None, :]
            - 2.0 * a @ b.T)


class IVFIndex(NamedTuple):
    centroids: torch.Tensor    # (nlist, d)
    lists: torch.Tensor        # (nlist, max_cell) int64 ids, then -1 pads
    vectors: torch.Tensor      # (N, d) the stored (possibly reduced) rows


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
    Cluster sums go through ``segment_sum``: on the card JAX's one-hot
    matmul taken in row chunks (the whole (N, nlist) one-hot at 1M x 1024
    would be 4 GB), so a build repeats bit for bit there; on the CPU
    ``index_add_`` in row order.
    """
    n = x.shape[0]
    if init is None:
        init = torch.randperm(n, generator=generator)[:nlist]
    cent = x[torch.as_tensor(init, dtype=torch.int64).to(x.device)]
    for _ in range(iters):
        assign = nearest(x, cent)
        counts = torch.bincount(assign, minlength=nlist).to(x.dtype)
        sums = segment_sum(x, assign, nlist)
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


def build_ivf(vectors: torch.Tensor, nlist: int, kmeans_iters: int = 12, *,
              init: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> IVFIndex:
    """Coarse k-means over ``vectors`` (starting rows ``init``, else drawn
    from ``generator``; see ``kmeans``), then the posting lists."""
    vectors = vectors.to(torch.float32)
    cent = kmeans(vectors, nlist, kmeans_iters, init=init,
                  generator=generator)
    lists = posting_lists(nearest(vectors, cent), nlist)
    return IVFIndex(centroids=cent, lists=lists, vectors=vectors)


def cell_vectors(lists: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """Cell-major mirror of the stored rows: (nlist, max_cell, d), posting
    pads as zero rows."""
    cv = vectors[lists.clamp_min(0)]
    return torch.where((lists >= 0)[..., None], cv, 0.0)


def ivf_scan(index: IVFIndex, q: torch.Tensor, k: int, nprobe: int = 8):
    """Probe the ``nprobe`` nearest cells and scan their rows exactly:
    (dists (Q, k), ids (Q, k)), with (+inf, -1) where fewer than k rows
    were probed."""
    q = q.to(torch.float32)
    cent, lists, vecs = index
    _, cand, _ = probe_cells(cent, lists, q, nprobe, k)
    valid = cand >= 0
    cv = vecs[cand.clamp_min(0)]                          # (Q, C, d)
    d2 = ((cv - q[:, None, :]) ** 2).sum(dim=-1)
    d2 = torch.where(valid, d2, float("inf"))
    vals, sel = topk_smallest(d2, k)
    ids = torch.gather(cand, 1, sel)
    return vals.clamp_min(0.0).sqrt(), ids


def ivf_search(index: IVFIndex, q: torch.Tensor, k: int, nprobe: int = 8):
    """Probe the nprobe nearest cells; returns (dists (Q, k), ids (Q, k)).
    The JAX package jits ``ivf_scan`` under this name; the port runs it
    eagerly."""
    return ivf_scan(index, q, k, nprobe)
