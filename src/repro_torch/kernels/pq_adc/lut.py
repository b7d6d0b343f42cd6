"""Quantized ADC lookup tables: f32 -> bf16 / int8 per-query tables.

Port of ``repro.kernels.pq_adc.lut``. The arithmetic is the same expression
for expression, so every produced value is bit-identical to the JAX
package's: int8 uses one symmetric scale per query (``max|t| / 127`` with a
``1e-12`` floor, or a caller-certified bound), rounds half to even
(``torch.round``) and clips to [-127, 127]; bf16 is the round-to-nearest-
even cast.

``snap_lut`` / ``snap_values`` round onto the same bf16 / int8 grid but
keep the values in f32 (int8 entries as exact small integers), which is
how the plain ADC scan scores: per-candidate sums of <= M such integers
are exact in f32, so summing and applying the scale once reproduces the
int32-accumulate kernel bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["LUT_DTYPES", "center_lut", "quantize_lut", "dequantize_lut",
           "snap_lut", "snap_values", "lut_error_bound"]

LUT_DTYPES = ("f32", "bf16", "int8")


def _check_lut_dtype(lut_dtype: str):
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(
            f"unknown lut_dtype {lut_dtype!r}; expected one of {LUT_DTYPES}")


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32 with ONE rounding, as a fused multiply-add gives it.

    Inside ``jit`` XLA contracts ``c + a * b`` into an FMA, so the JAX
    package's int8 scores (``base + sum * scale``) and certified scales are
    FMA results; the CUDA kernel uses ``__fmaf_rn``. PyTorch has no fma
    operator, so this computes it exactly: the f32 product is exact in f64,
    the f64 sum is rounded to odd (TwoSum error term, then one step toward
    it when the sum is inexact and even), and rounding that to f32 is the
    correctly rounded a * b + c (53 >= 24 + 2 bits). Non-finite sums pass
    through.
    """
    a, b, c = (t.to(torch.float64) for t in torch.broadcast_tensors(a, b, c))
    p = a * b                                   # exact: 24 + 24 <= 53 bits
    s = p + c
    bv = s - p
    err = (c - bv) + (p - (s - bv))             # TwoSum: s + err == p + c
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    odd = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return torch.where(torch.isfinite(s), odd, s).to(torch.float32)


def center_lut(tables: torch.Tensor):
    """Split (Q, M, K) tables into a zero-mean part plus a per-query
    constant: returns (tables - rowmean, sum_m rowmean (Q,))."""
    rowmean = tables.mean(dim=-1)                         # (Q, M)
    return tables - rowmean[..., None], rowmean.sum(dim=-1)


def _int8_scale(tables: torch.Tensor, scale=None) -> torch.Tensor:
    """Per-query int8 scale: caller-provided or max|t| / 127."""
    if scale is not None:
        return torch.as_tensor(scale, dtype=torch.float32,
                               device=tables.device)
    amax = tables.abs().amax(dim=(1, 2))                  # (Q,)
    # floor well above the subnormal range: a zero scale would NaN the
    # dequantized 0/0 tables
    return amax.clamp_min(1e-12) / 127.0


def quantize_lut(tables: torch.Tensor, lut_dtype: str, scale=None):
    """(Q, M, K) f32 tables -> (qtables, scale (Q,) f32).

    ``qtables`` is float32, bfloat16 or int8 per ``lut_dtype``; ``scale``
    is all ones except for int8.
    """
    _check_lut_dtype(lut_dtype)
    tables = tables.to(torch.float32)
    ones = torch.ones(tables.shape[:1], dtype=torch.float32,
                      device=tables.device)
    if lut_dtype == "f32":
        return tables, ones
    if lut_dtype == "bf16":
        return tables.to(torch.bfloat16), ones
    s = _int8_scale(tables, scale)
    q = torch.round(tables / s[:, None, None])
    return q.clamp(-127, 127).to(torch.int8), s


def snap_values(x: torch.Tensor, lut_dtype: str, scale=None) -> torch.Tensor:
    """Elementwise grid snap of f32 values, kept in f32.

    bf16: the bf16 rounding widened back to f32. int8: the clipped integer
    code as an f32 (``scale`` is required and must broadcast against
    ``x``). f32 passes through.
    """
    _check_lut_dtype(lut_dtype)
    if lut_dtype == "f32":
        return x
    if lut_dtype == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return torch.round(x / scale).clamp(-127.0, 127.0)


def snap_lut(tables: torch.Tensor, lut_dtype: str, scale=None):
    """Round whole tables onto the ``lut_dtype`` grid but keep them f32;
    same (Q, M, K) -> (ftables, scale (Q,)) convention as ``quantize_lut``."""
    _check_lut_dtype(lut_dtype)
    tables = tables.to(torch.float32)
    ones = torch.ones(tables.shape[:1], dtype=torch.float32,
                      device=tables.device)
    if lut_dtype in ("f32", "bf16"):
        return snap_values(tables, lut_dtype), ones
    s = _int8_scale(tables, scale)
    return snap_values(tables, lut_dtype, s[:, None, None]), s


def dequantize_lut(qtables: torch.Tensor, scale: torch.Tensor
                   ) -> torch.Tensor:
    """Inverse of ``quantize_lut`` up to rounding: (Q, M, K) f32."""
    return qtables.to(torch.float32) * scale[:, None, None]


def lut_error_bound(tables: torch.Tensor, lut_dtype: str,
                    scale=None) -> torch.Tensor:
    """Per-query upper bound on |quantized ADC score - f32 ADC score|:
    M * scale / 2 for int8, M * max|t| * 2^-8 for bf16, 0 for f32."""
    tables = tables.to(torch.float32)
    m = tables.shape[1]
    if lut_dtype == "f32":
        return torch.zeros(tables.shape[:1], dtype=torch.float32,
                           device=tables.device)
    if lut_dtype == "bf16":
        amax = tables.abs().amax(dim=(1, 2))
        return m * amax * 2.0 ** -8
    return m * _int8_scale(tables, scale) / 2.0
