"""Baseline DR methods the paper compares against (port of
``repro.core.baselines``).

  * PCA                 — SVD of the centered data
  * Random projection   — Achlioptas 2003 (gaussian + sparse ±1 variants)
  * Classical MDS       — Torgerson double-centering; out-of-sample via
                          ridge linear regression
  * Kernel PCA (RBF)    — centered-kernel eigendecomposition; optional
                          Nyström landmarks
  * Isomap              — k-NN graph + min-plus geodesics + MDS; landmark
                          (de Silva–Tenenbaum) out-of-sample
  * UMAP-lite           — fuzzy k-NN graph + attraction / negative-sampling
                          repulsion SGD; out-of-sample = fuzzy-weighted
                          average of neighbour embeddings

Every ``fit_*`` returns a :class:`Reducer` whose ``transform`` maps
out-of-sample points, on the device of the data it was fitted on. The
Isomap and UMAP transforms take their k nearest training points from
``knn_topk``, which is kernel K3 on a CUDA tensor. The fits' own N x N
neighbour sets stay plain torch, as JAX computes them outside any kernel.

Where JAX draws from ``jax.random``, the port takes a ``torch.Generator``
and also accepts the drawn values themselves (the projection's draws, the
Nyström landmarks, UMAP's negatives), so a test can feed in JAX's. SVD and
eigenvector signs are the linear-algebra library's choice, as in JAX:
compare embeddings up to column signs.

Transforms of many rows run in row chunks where JAX builds one large
intermediate (the kPCA kernel rows, the Isomap hops, the UMAP neighbour
embeddings); each row is independent, so the results do not change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch._device import cpu_generator
from repro_torch._segment import SegmentSum
from repro_torch.kernels.knn_topk import knn_topk

__all__ = [
    "Reducer", "fit_pca", "fit_random_projection", "fit_mds", "fit_kpca_rbf",
    "fit_isomap", "fit_umap_lite", "BASELINE_FITTERS",
]

# elements of one chunk's largest intermediate (512 MB in f32)
_CHUNK_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class Reducer:
    """A fitted DR method: callable transform + (for the affine methods)
    the fitted arrays as ``(matrix (m, D), mean (D,))``, the layout of the
    engine's linear reducers. Nonlinear methods leave ``params`` None."""
    name: str
    transform: Callable[[torch.Tensor], torch.Tensor]
    params: Any = None

    def __call__(self, x):
        return self.transform(x)


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _rows(n: int, width: int) -> int:
    """Rows per chunk when one row of the intermediate holds ``width``
    elements."""
    return max(1, _CHUNK_ELEMS // max(1, width))


# ---------------------------------------------------------------- PCA

def fit_pca(x, m: int) -> Reducer:
    x = _f32(x)
    mean = x.mean(dim=0)
    _, _, vt = torch.linalg.svd(x - mean, full_matrices=False)
    comps = vt[:m]                                   # (m, D)
    return Reducer("pca", lambda y: (_f32(y) - mean) @ comps.T,
                   params=(comps, mean))


# ------------------------------------------------- Random projection

def fit_random_projection(generator: Optional[torch.Generator], n: int,
                          m: int, kind: str = "gaussian", *,
                          draws: Optional[torch.Tensor] = None,
                          device=None) -> Reducer:
    """``draws`` (n, m): the standard normals (gaussian) or uniforms on
    [0, 1) (achlioptas) the matrix is made from; drawn from ``generator``
    when absent."""
    if kind not in ("gaussian", "achlioptas"):
        raise ValueError(kind)
    if draws is None:
        gen = generator if generator is not None else cpu_generator(0)
        draws = (torch.randn((n, m), generator=gen) if kind == "gaussian"
                 else torch.rand((n, m), generator=gen))
    draws = _f32(draws, device)
    root_m = torch.sqrt(torch.tensor(float(m)))
    if kind == "gaussian":
        mat = draws / root_m.to(draws.device)
    else:                                 # sparse ±sqrt(3), 2/3 zeros
        s3 = math.sqrt(3.0)
        mat = torch.where(draws < 1 / 6, s3,
                          torch.where(draws < 1 / 3, -s3, 0.0))
        mat = mat / root_m.to(draws.device)
    return Reducer(f"rp_{kind}", lambda y: _f32(y) @ mat,
                   params=(mat.T, mat.new_zeros(n)))


# --------------------------------------------------- Classical MDS

def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aa = (a * a).sum(dim=1)[:, None]
    bb = (b * b).sum(dim=1)[None, :]
    return (aa + bb - 2.0 * (a @ b.T)).clamp_min(0.0)


def _classical_mds_embed(d2: torch.Tensor, m: int):
    """Torgerson: B = -1/2 H D^2 H; coords = V sqrt(lambda). Returns
    (Y, V, lam)."""
    n = d2.shape[0]
    h = (torch.eye(n, device=d2.device)
         - torch.full((n, n), 1.0 / n, device=d2.device))
    b = -0.5 * h @ d2 @ h
    lam, v = torch.linalg.eigh(b)                    # ascending
    lam, v = lam.flip(0)[:m], v.flip(1)[:, :m]
    lam = lam.clamp_min(1e-9)
    return v * lam.sqrt()[None, :], v, lam


def fit_mds(x, m: int, ridge: float = 1e-4) -> Reducer:
    """Classical MDS + ridge-regression out-of-sample map."""
    x = _f32(x)
    mean = x.mean(dim=0)
    xc = x - mean
    y, _, _ = _classical_mds_embed(_sq_dists(x, x), m)
    n_dim = xc.shape[1]
    w = torch.linalg.solve(
        xc.T @ xc + ridge * torch.eye(n_dim, device=x.device), xc.T @ y)
    return Reducer("mds", lambda q: (_f32(q) - mean) @ w,
                   params=(w.T, mean))


# ------------------------------------------------- Kernel PCA (RBF)

def _median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even count
    (``torch.median`` returns the lower one)."""
    s = torch.sort(v).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _median_heuristic_gamma(x: torch.Tensor) -> torch.Tensor:
    d2 = _sq_dists(x, x)
    n = x.shape[0]
    iu, ju = torch.triu_indices(n, n, offset=1, device=x.device)
    return 1.0 / _median(d2[iu, ju]).clamp_min(1e-9)


def fit_kpca_rbf(x, m: int, gamma: Optional[float] = None,
                 landmarks: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None,
                 landmark_idx: Optional[torch.Tensor] = None) -> Reducer:
    """RBF Kernel PCA with centered-kernel OOS; Nyström if ``landmarks``
    set (``landmark_idx``: the rows chosen, else drawn without replacement
    from ``generator``)."""
    x = _f32(x)
    if landmarks is not None and landmarks < x.shape[0]:
        if landmark_idx is None:
            gen = generator if generator is not None else cpu_generator(0)
            landmark_idx = torch.randperm(x.shape[0], generator=gen)[
                :landmarks]
        x = x[torch.as_tensor(landmark_idx, device=x.device).long()]
    g = (_median_heuristic_gamma(x) if gamma is None
         else torch.tensor(float(gamma), device=x.device))
    k = torch.exp(-g * _sq_dists(x, x))
    n = x.shape[0]
    one = torch.full((n, n), 1.0 / n, device=x.device)
    kc = k - one @ k - k @ one + one @ k @ one
    lam, v = torch.linalg.eigh(kc)
    lam, v = lam.flip(0)[:m], v.flip(1)[:, :m]
    lam = lam.clamp_min(1e-9)
    alphas = v / lam.sqrt()[None, :]                 # (n, m)
    k_row_mean = k.mean(dim=0)                       # (n,)
    k_all_mean = k.mean()

    def transform(q):
        q = _f32(q)
        rows = _rows(q.shape[0], n)
        out = []
        for i in range(0, q.shape[0], rows):
            kq = torch.exp(-g * _sq_dists(q[i:i + rows], x))
            kq_c = (kq - kq.mean(dim=1, keepdim=True)
                    - k_row_mean[None, :] + k_all_mean)
            out.append(kq_c @ alphas)
        return torch.cat(out) if out else q.new_zeros((0, m))

    return Reducer("kpca", transform)


# ----------------------------------------------------------- Isomap

def _minplus_geodesics(d: torch.Tensor, iters: int) -> torch.Tensor:
    """All-pairs shortest paths by iterated min-plus squaring of (N, N)
    distances, in row chunks (min is exact, so chunks change nothing)."""
    n = d.shape[0]
    g = d
    rows = _rows(n, n * n)
    for _ in range(iters):
        # g2[i, j] = min_k g[i, k] + g[k, j]: one-hop relaxation doubling
        g2 = torch.cat([(g[i:i + rows, :, None] + g[None, :, :]).amin(dim=1)
                        for i in range(0, n, rows)])
        g = torch.minimum(g, g2)
    return g


def fit_isomap(x, m: int, k: int = 10) -> Reducer:
    x = _f32(x).contiguous()
    n = x.shape[0]
    d = _sq_dists(x, x).sqrt()
    # symmetric k-NN graph: keep an edge if either endpoint ranks it in top-k
    kth = torch.sort(d, dim=1).values[:, k]   # k-th neighbour (self at 0)
    adj = (d <= kth[:, None]) | (d <= kth[None, :])
    big = 1e9
    graph = torch.where(adj, d, big)
    graph = torch.where(torch.eye(n, dtype=torch.bool, device=x.device), 0.0,
                        graph)
    iters = max(1, math.ceil(math.log2(n)))
    geo = _minplus_geodesics(graph, iters)
    # disconnected components: cap at 1.5 x the largest finite geodesic
    finite = geo < big / 2
    gmax = torch.where(finite, geo, 0.0).max()
    geo = torch.where(finite, geo, 1.5 * gmax)
    _, v, lam = _classical_mds_embed(geo * geo, m)
    col_mean = (geo * geo).mean(dim=0)               # (n,)
    lhalf_pinv = v / lam.sqrt()[None, :]             # (n, m)

    def transform(q):
        q = _f32(q).contiguous()
        # approx geodesic from a test point: hop through its k nearest
        # training points (kernel K3 on the card)
        knn_d, knn_i = knn_topk(q, x, k)
        out = []
        rows = _rows(q.shape[0], k * n)
        for i in range(0, q.shape[0], rows):
            hop = knn_d[i:i + rows, :, None] + geo[knn_i[i:i + rows]]
            geo_q = hop.amin(dim=1)                  # (rows, n)
            # landmark-MDS triangulation (de Silva & Tenenbaum)
            out.append(0.5 * (col_mean[None, :] - geo_q ** 2) @ lhalf_pinv)
        return torch.cat(out) if out else q.new_zeros((0, m))

    return Reducer("isomap", transform)


# -------------------------------------------------------- UMAP-lite

_UMAP_A, _UMAP_B = 1.576943, 0.8950609   # min_dist=0.1 curve fit (umap-learn)


def fit_umap_lite(x, m: int, k: int = 15, epochs: int = 150, *,
                  generator: Optional[torch.Generator] = None,
                  lr: float = 1.0, n_neg: int = 5,
                  negatives: Optional[torch.Tensor] = None) -> Reducer:
    """Reduced-fidelity UMAP: fuzzy graph + SGD, vectorized over all edges.

    ``negatives`` (epochs, n_neg, n * k * 2) int: the random rows each
    epoch's repulsion rounds push away from (drawn from ``generator`` when
    absent). The scatter-adds run in sequence (attraction, then each
    negative round on the updated embedding), as in JAX; each adds its
    edges' updates into the embedding through a ``SegmentSum`` of its edge
    list, made once a fit: ``index_add`` on the CPU, a fixed-order sum on
    the card, so a fit repeats bit for bit there.
    """
    from repro_torch.search.knn import topk_smallest

    x = _f32(x).contiguous()
    dev = x.device
    gen = generator if generator is not None else cpu_generator(0)
    n = x.shape[0]
    d = _sq_dists(x, x).sqrt()
    d = d + torch.eye(n, device=dev) * 1e9
    knn_d, knn_i = topk_smallest(d, k)               # (n, k), lax.top_k order
    rho = knn_d[:, 0:1]
    # binary search sigma_i: sum_j exp(-(d_ij - rho_i)/sigma_i) = log2(k)
    target = torch.log2(torch.tensor(float(k), device=dev))
    lo = torch.full((n,), 1e-4, device=dev)
    hi = torch.full((n,), 1e3, device=dev)
    gap = (knn_d - rho).clamp_min(0.0)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        s = torch.exp(-gap / mid[:, None]).sum(dim=1)
        too_big = s > target
        lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
    sigma = hi
    w_knn = torch.exp(-gap / sigma[:, None])         # (n, k)
    # symmetrize into a dense fuzzy graph (N small in the paper's protocol)
    wdense = torch.zeros((n, n), device=dev)
    wdense[torch.arange(n, device=dev)[:, None], knn_i] = w_knn
    wsym = wdense + wdense.T - wdense * wdense.T
    # jnp.nonzero(size=n*k*2, fill_value=0): row-major edges, padded with
    # (0, 0) edges (their weight wsym[0, 0] is 0) or cut at that size
    n_edges = n * k * 2
    nz = torch.nonzero(wsym > 1e-3)[:n_edges]
    edges = torch.zeros((n_edges, 2), dtype=torch.int64, device=dev)
    edges[:nz.shape[0]] = nz
    src, dst = edges[:, 0], edges[:, 1]
    ew = wsym[src, dst][:, None]
    # PCA init, small scale
    init = fit_pca(x, m).transform(x)
    emb = 1e-2 * init / (init.std(correction=0) + 1e-9)
    a, b = _UMAP_A, _UMAP_B
    if negatives is None:
        negatives = torch.randint(0, n, (epochs, n_neg, n_edges),
                                  generator=gen)
    negatives = torch.as_tensor(negatives, device=dev).long()
    alphas = lr * (1.0 - torch.arange(epochs, dtype=torch.float32,
                                      device=dev) / epochs)
    add_src, add_dst = SegmentSum(src, n), SegmentSum(dst, n)
    for ep in range(epochs):
        alpha = alphas[ep]
        e = emb[src] - emb[dst]
        d2 = (e * e).sum(dim=1, keepdim=True).clamp_min(1e-8)
        grad_coef = (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + a * d2 ** b)
        att = (grad_coef * e).clamp(-4.0, 4.0) * ew
        emb = add_src(alpha * att, emb)
        emb = add_dst(-alpha * att, emb)
        for t in range(n_neg):
            neg = negatives[ep, t]
            e = emb[src] - emb[neg]
            d2 = (e * e).sum(dim=1, keepdim=True).clamp_min(1e-8)
            rep = (2.0 * b) / ((1e-3 + d2) * (1.0 + a * d2 ** b))
            emb = add_src(alpha * (rep * e).clamp(-4.0, 4.0) * ew, emb)

    def transform(q):
        q = _f32(q).contiguous()
        # the k nearest training points (kernel K3 on the card)
        nb_d, nb_i = knn_topk(q, x, k)
        wq = torch.exp(-(nb_d - nb_d[:, 0:1]).clamp_min(0.0))
        wq = wq / wq.sum(dim=1, keepdim=True)
        rows = _rows(q.shape[0], k * m)
        out = [torch.einsum("dk,dkm->dm", wq[i:i + rows],
                            emb[nb_i[i:i + rows]])
               for i in range(0, q.shape[0], rows)]
        return torch.cat(out) if out else q.new_zeros((0, m))

    return Reducer("umap", transform)


# name -> fit(x, m, generator) -> Reducer, as the benchmark harness calls them
BASELINE_FITTERS = {
    "pca": lambda x, m, gen: fit_pca(x, m),
    "rp": lambda x, m, gen: fit_random_projection(gen, x.shape[1], m,
                                                  device=x.device),
    "mds": lambda x, m, gen: fit_mds(x, m),
    "kpca": lambda x, m, gen: fit_kpca_rbf(x, m),
    "isomap": lambda x, m, gen: fit_isomap(x, m),
    "umap": lambda x, m, gen: fit_umap_lite(x, m, generator=gen),
}
