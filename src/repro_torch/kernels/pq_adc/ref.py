"""Plain PyTorch version of the fused ADC-gather top-k (kernel K1).

Port of the gathered-codes half of ``repro.kernels.pq_adc.ref``: the
semantic spec that the CUDA kernel in ``csrc/`` is held against, and what
the scan runs on CPU tensors and under the ``@jnp`` backend.

    out[q, c] = base[q, c] + sum_m tables[q, m, codes[q, c, m]]

The tables are snapped onto the ``lut_dtype`` grid but kept in f32 (see
``lut.py``), so the lookup is one flat gather over the (Q, M*K) table at
f32 regardless of the LUT precision, and int8 scores (exact integer sums
times one per-query scale) are bit-identical to the kernel's int32 path.

``scale`` (int8 only) overrides the per-query scale with a caller-certified
bound; ``center`` (Q, M) is subtracted from the tables before the snap and
the returned score omits ``sum_m center`` (the caller adds it back after
top-k). The selection is ``topk_smallest``: ascending, ties to the lower
slot, as ``lax.top_k`` orders them.
"""
from __future__ import annotations

import torch

from repro_torch.search.knn import topk_smallest

from .lut import _int8_scale, fma_f32, snap_values

__all__ = ["pq_adc_gather_scores_ref", "pq_adc_gather_topk_ref"]


def _resolve_scale(tables, lut_dtype, scale, center):
    """Per-query int8 scale: caller-certified, or max|t - center| / 127."""
    if lut_dtype != "int8":
        return None
    if scale is not None:
        return torch.as_tensor(scale, dtype=torch.float32,
                               device=tables.device)
    ct = tables if center is None else tables - center[:, :, None]
    return _int8_scale(ct, None)


def _snap_tables(tables, lut_dtype, scale, center):
    """Center + grid-snap the (Q, M, K) tables. As in the JAX version a
    non-finite first entry (a non-finite query) keeps the tables unsnapped;
    the choice is made on the device, without a host sync."""
    if lut_dtype == "f32":
        return tables
    tc = tables if center is None else tables - center[:, :, None]
    snapped = snap_values(tc, lut_dtype,
                          None if scale is None else scale[:, None, None])
    return torch.where(torch.isfinite(tables[0, 0, 0]), snapped, tables)


def pq_adc_gather_scores_ref(tables: torch.Tensor, codes: torch.Tensor,
                             base: torch.Tensor, lut_dtype: str = "f32",
                             scale=None, center=None) -> torch.Tensor:
    """ADC distances over per-query candidate codes.

    tables (Q, M, K) f32; codes (Q, C, M) uint8 or int; base (Q, C) f32
    (+inf masks padded candidates; never quantized). Returns (Q, C) f32
    (minus ``sum_m center`` when ``center`` is given).
    """
    tables = tables.to(torch.float32)
    nq, m, kc = tables.shape
    scale = _resolve_scale(tables, lut_dtype, scale, center)
    ft = _snap_tables(tables, lut_dtype, scale, center)
    c = codes.shape[1]
    offs = torch.arange(m, device=codes.device, dtype=torch.int64) * kc
    flat_idx = (codes.to(torch.int64) + offs).reshape(nq, c * m)
    lut = torch.gather(ft.reshape(nq, m * kc), 1, flat_idx)
    d2 = lut.reshape(nq, c, m).sum(dim=-1)
    if lut_dtype == "int8":
        # exact integer sums, one rescale fused with the base add (as XLA
        # and the kernel compute it)
        return fma_f32(d2, scale[:, None], base)
    return base.to(torch.float32) + d2


def pq_adc_gather_topk_ref(tables: torch.Tensor, codes: torch.Tensor,
                           base: torch.Tensor, k: int, lut_dtype: str = "f32",
                           scale=None, center=None):
    """Returns (d2 (Q, k) ascending, slot (Q, k) int64), the order of
    ``lax.top_k``; masked slots keep their +inf score and their slot id."""
    d2 = pq_adc_gather_scores_ref(tables, codes, base, lut_dtype, scale,
                                  center)
    return topk_smallest(d2, k)
