"""IVF-Flat: the coarse k-means quantizer, posting lists and the probed
exact scan (port of ``repro.search.ivf``).

Posting lists are padded-dense: a (nlist, max_cell) id matrix with -1
pads, so the probe is a gather plus a masked top-k. Ids and lists are
int64, PyTorch's index type. The ivf scan has no kernel behind it, in
the JAX package either: a gather of the probed rows and a top-k.

Sharded serving splits the cell axis over the ranks of a mesh:
``posting_lists(..., shards=)`` pads it with empty cells to a multiple of
the shard count, ``balance_cells`` permutes it so each rank's block
carries near-equal posting mass, and ``ivf_local_scan`` scans the probed
cells one rank owns, returning global row ids.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._segment import segment_sum

from .knn import masked_topk, topk_smallest
from .tracing import span

__all__ = ["IVFIndex", "sq_dists", "nearest", "kmeans", "posting_lists",
           "balance_cells", "probe_cells", "build_ivf", "cell_vectors",
           "ivf_local_scan", "ivf_scan", "ivf_search"]

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


def posting_lists(assign: torch.Tensor, nlist: int,
                  shards: int = 1) -> torch.Tensor:
    """Padded-dense posting lists from a cell assignment: (nlist_pad,
    max_cell) int64 ids, -1 = pad; each row holds its ids ascending, then
    pads. ``shards`` pads the cell axis up to a multiple with empty (all
    -1) cells, so the layout splits into per-shard-equal blocks (sharded
    serving); the probe never reaches a pad cell (its ids are < nlist)."""
    counts = torch.bincount(assign, minlength=nlist)
    max_cell = int(counts.max())
    nlist_pad = -(-nlist // shards) * shards
    order = torch.argsort(assign, stable=True)
    sorted_cells = assign[order]
    # position of each sorted element within its cell
    pos = (torch.arange(order.shape[0], device=assign.device)
           - torch.searchsorted(sorted_cells, sorted_cells, side="left"))
    lists = torch.full((nlist_pad, max_cell), -1, dtype=torch.int64,
                       device=assign.device)
    lists[sorted_cells, pos] = order
    return lists


def balance_cells(counts, shards: int) -> np.ndarray:
    """Load-aware cell placement: a permutation of the cell axis whose
    per-shard contiguous blocks carry near-equal posting mass (rows), not
    only equal cell counts.

    Greedy LPT bin-pack: cells heaviest first, each onto the lightest
    shard that still has slots. Shard s's slot budget is the block size
    ``ceil(nlist / shards)``, less the tail blocks' share of the pad cells
    ``posting_lists`` appends (pads stay at the end of the cell axis).
    Host-side (numpy, build time); apply the permutation to the centroids
    and the assignment together.
    """
    counts = np.asarray(counts)
    nlist = counts.shape[0]
    per = -(-nlist // shards)
    caps = np.full(shards, per)
    deficit = per * shards - nlist
    s = shards - 1
    while deficit > 0:                     # pad cells live in the tail blocks
        take = min(per, deficit)
        caps[s] -= take
        deficit -= take
        s -= 1
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(shards, dtype=np.int64)
    members: list = [[] for _ in range(shards)]
    for c in order:
        elig = [i for i in range(shards) if len(members[i]) < caps[i]]
        tgt = min(elig, key=lambda i: (load[i], i))
        members[tgt].append(int(c))
        load[tgt] += int(counts[c])
    return np.concatenate(
        [np.asarray(m, dtype=np.int64) for m in members if m])


def _balanced_layout(cent: torch.Tensor, assign: torch.Tensor, nlist: int,
                     shards: int):
    """Permute the cell axis by ``balance_cells`` (the centroid order is
    arbitrary: the layout changes, the scan results do not)."""
    counts = torch.bincount(assign, minlength=nlist).cpu().numpy()
    perm = balance_cells(counts, shards)
    inv = np.empty(nlist, np.int64)
    inv[perm] = np.arange(nlist, dtype=np.int64)
    return (cent[torch.from_numpy(perm).to(cent.device)],
            torch.from_numpy(inv).to(assign.device)[assign])


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
              generator: Optional[torch.Generator] = None,
              shards: int = 1, balance: bool = True) -> IVFIndex:
    """Coarse k-means over ``vectors`` (starting rows ``init``, else drawn
    from ``generator``; see ``kmeans``), then the posting lists, their
    cell axis padded to a multiple of ``shards``; ``balance`` (with
    ``shards > 1``) permutes the cells so the shard blocks carry
    near-equal posting mass (``balance_cells``)."""
    vectors = vectors.to(torch.float32)
    cent = kmeans(vectors, nlist, kmeans_iters, init=init,
                  generator=generator)
    assign = nearest(vectors, cent)
    if balance and shards > 1:
        cent, assign = _balanced_layout(cent, assign, nlist, shards)
    lists = posting_lists(assign, nlist, shards)
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
    with span("search.probe"):
        _, cand, _ = probe_cells(cent, lists, q, nprobe, k)
    with span("search.scan"):
        valid = cand >= 0
        cv = vecs[cand.clamp_min(0)]                      # (Q, C, d)
        d2 = ((cv - q[:, None, :]) ** 2).sum(dim=-1)
        d2 = torch.where(valid, d2, float("inf"))
        vals, sel = topk_smallest(d2, k)
        ids = torch.gather(cand, 1, sel)
        return vals.clamp_min(0.0).sqrt(), ids


def ivf_local_scan(centroids: torch.Tensor, lists_loc: torch.Tensor,
                   cell_vecs_loc: torch.Tensor, q: torch.Tensor, n_cand: int,
                   nprobe: int, shard: int,
                   live: Optional[torch.Tensor] = None):
    """Shard-local IVF probe + scan (sharded serving).

    The coarse probe runs on the replicated ``centroids``, so it equals
    the single-device probe on every rank; only the probed cells this
    rank owns (rows of ``lists_loc`` / ``cell_vecs_loc``, the cell block
    starting at ``shard * nlist_local``) are scanned. Returns (d2 (Q,
    n_cand), global ids (Q, n_cand)); slots of cells owned elsewhere, and
    posting pads, are (+inf, -1). ``live`` (n_cap,) bool (streaming)
    masks tombstoned and unallocated rows before the local top-k.
    """
    q = q.to(torch.float32)
    _, probe = topk_smallest(sq_dists(q, centroids), nprobe)  # global ids
    nl_loc = lists_loc.shape[0]
    lp = probe - shard * nl_loc
    own = (lp >= 0) & (lp < nl_loc)                       # (Q, nprobe)
    lpc = lp.clamp(0, nl_loc - 1)
    cand = torch.where(own[:, :, None], lists_loc[lpc], -1)
    if live is not None:
        n_cap = live.shape[0]
        cand = torch.where(live[cand.clamp(0, n_cap - 1)], cand, -1)
    cv = cell_vecs_loc[lpc]                               # (Q, P, mc, d)
    d2 = ((cv - q[:, None, None, :]) ** 2).sum(dim=-1)
    nq = q.shape[0]
    cand = cand.reshape(nq, -1)
    d2 = torch.where(cand >= 0, d2.reshape(nq, -1), float("inf"))
    return masked_topk(d2, cand, n_cand)


def ivf_search(index: IVFIndex, q: torch.Tensor, k: int, nprobe: int = 8):
    """Probe the nprobe nearest cells; returns (dists (Q, k), ids (Q, k)).
    The JAX package jits ``ivf_scan`` under this name; the port runs it
    eagerly."""
    return ivf_scan(index, q, k, nprobe)
