"""Product quantization: codebook training, per-query ADC tables and the
plain-PQ scans (port of ``repro.search.pq``).

``pq_scan`` scores the candidate-varying table part through the shared-
codes ADC top-k: kernel K2 (``repro_torch.kernels.pq_adc.ops.pq_adc_topk``)
under ``backend="kernel"``, its plain version under ``backend="jnp"`` (the
spec grammar's token, so one spec string drives both packages).
``pq_local_scan`` is the shard-local scan of sharded serving: one rank's
row block of the codes, global ids, K2 through its global entry
(``pq_adc_topk_global``) under ``backend="kernel"``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_adc.lut import LUT_DTYPES, center_lut
from repro_torch.kernels.pq_adc.ref import pq_adc_scores_ref

from .ivf import kmeans, nearest
from .knn import masked_topk

__all__ = ["PQIndex", "adc_tables", "build_pq", "lut_projection",
           "pq_local_scan", "pq_reconstruct", "pq_scan", "pq_search"]


class PQIndex(NamedTuple):
    codebooks: torch.Tensor    # (M, K, dsub)
    codes: torch.Tensor        # (N, M) uint8 (int32 if K > 256)
    lut_w: torch.Tensor        # (d, M*K) block-diagonal -2*codebook projection
    cbnorm: torch.Tensor       # (M, K) per-codeword squared norms


def lut_projection(codebooks: torch.Tensor):
    """Build-time table factorization: (lut_w (d, M*K), cbnorm (M, K));
    block m of ``lut_w`` is -2 * codebooks[m].T."""
    m, kc, dsub = codebooks.shape
    w = torch.zeros((m * dsub, m * kc), dtype=torch.float32,
                    device=codebooks.device)
    for j in range(m):
        w[j * dsub:(j + 1) * dsub, j * kc:(j + 1) * kc] = -2.0 * codebooks[j].T
    return w, (codebooks ** 2).sum(dim=-1)


def adc_tables(lut_w: torch.Tensor, cbnorm: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """Per-query ADC tables (Q, M, K): ``cbnorm + (q @ lut_w).reshape``,
    contracted subspace by subspace (one batched matmul over the M diagonal
    (dsub, K) blocks; the skipped products are exact zeros)."""
    m, kc = cbnorm.shape
    nq, d = q.shape
    dsub = d // m
    ar = torch.arange(m, device=q.device)
    blocks = lut_w.reshape(m, dsub, m, kc)[ar, :, ar, :]  # (M, dsub, K)
    qs = q.reshape(nq, m, dsub).transpose(0, 1)           # (M, Q, dsub)
    t = torch.bmm(qs, blocks)                             # (M, Q, K)
    return cbnorm[None] + t.transpose(0, 1)


def build_pq(x: torch.Tensor, m_subspaces: int = 8, n_centroids: int = 256,
             iters: int = 10, *, inits: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> PQIndex:
    """Train per-subspace codebooks and encode the rows.

    ``inits`` (M, min(K, N)) row indices of each subspace's starting
    codewords (JAX draws them per subspace from ``fold_in(key, m)``);
    without it they are drawn from ``generator``.
    """
    x = x.to(torch.float32)
    n, d = x.shape
    if d % m_subspaces:
        raise ValueError(f"dim {d} not divisible by M={m_subspaces}")
    dsub = d // m_subspaces
    kc = min(n_centroids, n)
    xs = x.reshape(n, m_subspaces, dsub)
    cbs, codes = [], []
    for m in range(m_subspaces):
        sub = xs[:, m].contiguous()
        cb = kmeans(sub, kc, iters,
                    init=None if inits is None else inits[m],
                    generator=generator)
        cbs.append(cb)
        codes.append(nearest(sub, cb))
    cbs = torch.stack(cbs)
    lut_w, cbnorm = lut_projection(cbs)
    code_dt = torch.uint8 if n_centroids <= 256 else torch.int32
    return PQIndex(codebooks=cbs, codes=torch.stack(codes, dim=1).to(code_dt),
                   lut_w=lut_w, cbnorm=cbnorm)


def _check_adc_args(backend: str, lut_dtype: str):
    if backend not in ("jnp", "kernel"):
        raise ValueError(f"unknown ADC backend {backend!r}")
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(
            f"unknown lut_dtype {lut_dtype!r}; expected one of {LUT_DTYPES}")


def pq_reconstruct(index: PQIndex) -> torch.Tensor:
    """Decode the rows (for error analysis): (N, D)."""
    m = index.codebooks.shape[0]
    return torch.cat([index.codebooks[j][index.codes[:, j].long()]
                      for j in range(m)], dim=1)


def pq_scan(index: PQIndex, q: torch.Tensor, k: int, backend: str = "jnp",
            lut_dtype: str = "f32"):
    """ADC top-k over the shared code matrix: (approx dists (Q, k), ids
    (Q, k)), with (+inf, -1) where k exceeds the row count.

    Only the candidate-varying table part (||cb||^2 - 2<q, cb>) goes
    through the (possibly quantized) scan; the per-query constants,
    ||q||^2 and, when quantizing, the table row means (``center_lut``),
    stay in f32 and are added back after top-k, so they cost no
    quantization range and cannot perturb the ranking.
    """
    _check_adc_args(backend, lut_dtype)
    q = q.to(torch.float32)
    tables = adc_tables(index.lut_w, index.cbnorm, q)
    const = (q * q).sum(dim=1)                            # (Q,) ||q||^2
    if lut_dtype != "f32":
        tables, offs = center_lut(tables)
        const = const + offs
    topk = (adc_ops.pq_adc_topk if backend == "kernel"
            else adc_ops.pq_adc_topk_plain)
    d2, ids = topk(tables, index.codes, k, lut_dtype)
    return (d2 + const[:, None]).clamp_min(0.0).sqrt(), ids


def pq_local_scan(lut_w: torch.Tensor, cbnorm: torch.Tensor,
                  codes_loc: torch.Tensor, q: torch.Tensor, n_cand: int,
                  n_real: int, shard: int, backend: str = "jnp",
                  lut_dtype: str = "f32", slack: int = 0, live=None):
    """Shard-local plain-PQ ADC scan (sharded serving): score this rank's
    row block of the row-padded code matrix and return global row ids.

    ``codes_loc`` is block ``shard`` (n_loc, M); rows whose global id
    ``shard * n_loc + row`` is at or past ``n_real`` are shard padding,
    (+inf, -1). Under ``backend="kernel"`` K2's global entry over-fetches
    ``slack`` rows (at least the pad rows: shards - 1) and drops the pads
    after. The table is quantized as on the single-device path; the
    per-query constant is dropped (it cannot change the ranking, and the
    final distances come from the exact re-rank). ``live`` (n_cap,) bool
    (streaming) masks tombstoned and unallocated rows; K2 only masks a
    row-count prefix, so it needs ``backend="jnp"``. On that streaming
    route the scores keep the per-query constant, as the single-device
    streaming scan's do: they are merged with the delta segment's exact
    distances, where a dropped constant would favour base rows (fault F6:
    the JAX package's sharded streaming scan drops it). Returns (d2 (Q,
    n_cand), global ids (Q, n_cand)).
    """
    _check_adc_args(backend, lut_dtype)
    q = q.to(torch.float32)
    tables = adc_tables(lut_w, cbnorm, q)
    const = (q * q).sum(dim=1)
    if lut_dtype != "f32":
        tables, offs = center_lut(tables)
        const = const + offs
    n_loc = codes_loc.shape[0]
    off = shard * n_loc
    if backend == "kernel":
        if live is not None:
            raise ValueError(
                "pq_local_scan(live=...) needs backend='jnp': the "
                "shared-codes kernel only masks a row-count prefix")
        return adc_ops.pq_adc_topk_global(tables, codes_loc, n_cand,
                                          row_offset=off, n_valid=n_real,
                                          slack=slack, lut_dtype=lut_dtype)
    scores = pq_adc_scores_ref(tables, codes_loc, lut_dtype)
    gid = off + torch.arange(n_loc, device=q.device)
    ok = gid < n_real
    if live is not None:
        scores = scores + const[:, None]
        ok = ok & live[gid.clamp(0, live.shape[0] - 1)]
    scores = torch.where(ok[None, :], scores, float("inf"))
    return masked_topk(scores, gid.expand(q.shape[0], n_loc), n_cand)


def pq_search(index: PQIndex, q: torch.Tensor, k: int, backend: str = "jnp",
              lut_dtype: str = "f32"):
    """ADC top-k: returns (approx dists (Q, k), ids (Q, k)). The JAX
    package jits ``pq_scan`` under this name; the port runs it eagerly."""
    return pq_scan(index, q, k, backend, lut_dtype)
