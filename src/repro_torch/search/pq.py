"""Product quantization: codebook training, per-query ADC tables and the
plain-PQ scan (port of ``repro.search.pq``, single-device read-only part).

``pq_scan`` scores the candidate-varying table part through the shared-
codes ADC top-k: kernel K2 (``repro_torch.kernels.pq_adc.ops.pq_adc_topk``)
under ``backend="kernel"``, its plain version under ``backend="jnp"`` (the
spec grammar's token, so one spec string drives both packages).

Not ported yet: ``pq_local_scan`` (sharded serving, ROADMAP item 11).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_adc.lut import LUT_DTYPES, center_lut

from .ivf import kmeans, nearest

__all__ = ["PQIndex", "adc_tables", "build_pq", "lut_projection",
           "pq_reconstruct", "pq_scan", "pq_search"]


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


def pq_search(index: PQIndex, q: torch.Tensor, k: int, backend: str = "jnp",
              lut_dtype: str = "f32"):
    """ADC top-k: returns (approx dists (Q, k), ids (Q, k)). The JAX
    package jits ``pq_scan`` under this name; the port runs it eagerly."""
    return pq_scan(index, q, k, backend, lut_dtype)
