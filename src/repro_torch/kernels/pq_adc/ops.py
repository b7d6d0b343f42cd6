"""Wrapper of the fused ADC-gather top-k kernel (K1).

``pq_adc_gather_topk`` takes the plain PyTorch version (``ref.py``) for
tensors on the CPU, and only for those; for CUDA tensors it launches the
CUDA kernel (``csrc/pq_adc_gather_topk.cu``) or raises. Each launch adds one
to ``pq_adc_gather_topk.launches``.

Contract (both routes): (d2 (Q, k) f32 ascending, slot (Q, k)) with ties
to the lower slot and (+inf, -1) where fewer than k candidates are finite.
"""
from __future__ import annotations

import torch

from .lut import LUT_DTYPES, quantize_lut
from .ref import pq_adc_gather_topk_ref

__all__ = ["pq_adc_gather_topk", "pq_adc_gather_topk_plain", "MAX_K"]

MAX_K = 8192                     # the kernel's largest chunk holds 2k pairs
_LUT_MODE = {"f32": 0, "bf16": 1, "int8": 2}
_SMEM_LIMIT = 232_448            # bytes of shared memory a Hopper block may use


def pq_adc_gather_topk_plain(tables, codes, base, k, lut_dtype="f32",
                             scale=None):
    """The plain PyTorch version under the kernel's contract: ``ref.py``'s
    top-k, with (+inf, -1) in unfilled slots and k > C padded. Runs on any
    device; the wrapper takes it for CPU tensors."""
    c = codes.shape[1]
    k_eff = min(k, c)
    d2, slot = pq_adc_gather_topk_ref(tables, codes, base, k_eff, lut_dtype,
                                      scale)
    slot = torch.where(d2 == float("inf"), -1, slot)
    if k_eff < k:
        d2 = torch.nn.functional.pad(d2, (0, k - k_eff), value=float("inf"))
        slot = torch.nn.functional.pad(slot, (0, k - k_eff), value=-1)
    return d2, slot


def _check(tables, codes, base, k, lut_dtype, scale):
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"unknown lut_dtype {lut_dtype!r}")
    if tables.ndim != 3 or codes.ndim != 3 or base.ndim != 2:
        raise ValueError("expected tables (Q, M, K), codes (Q, C, M), "
                         "base (Q, C)")
    nq, m, kc = tables.shape
    if codes.shape[0] != nq or codes.shape[2] != m or \
            tuple(base.shape) != tuple(codes.shape[:2]):
        raise ValueError(f"shape mismatch: tables {tuple(tables.shape)}, "
                         f"codes {tuple(codes.shape)}, base "
                         f"{tuple(base.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    devs = {t.device for t in (tables, codes, base)}
    if scale is not None:
        devs.add(torch.as_tensor(scale).device)
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def pq_adc_gather_topk(tables: torch.Tensor, codes: torch.Tensor,
                       base: torch.Tensor, k: int, lut_dtype: str = "f32",
                       scale=None):
    """Fused ADC scan over per-query candidate codes plus top-k.

    tables (Q, M, K) f32, quantized here per ``lut_dtype`` with
    ``quantize_lut`` (``scale`` optionally overrides the per-query int8
    scale with a caller-certified bound); codes (Q, C, M) uint8; base
    (Q, C) f32, +inf masking pads. Returns (d2 (Q, k) f32, slot (Q, k)
    int64).
    """
    _check(tables, codes, base, k, lut_dtype, scale)
    if tables.device.type == "cpu":
        return pq_adc_gather_topk_plain(tables, codes, base, k, lut_dtype,
                                        scale)
    if tables.device.type != "cuda":
        raise ValueError(f"no kernel for device {tables.device}")
    if codes.dtype == torch.int32:
        raise NotImplementedError(
            "int32 codes (K > 256) are not supported by the CUDA kernel yet")
    if codes.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {codes.dtype}")
    if base.dtype != torch.float32:
        raise TypeError(f"base must be float32, got {base.dtype}")
    if not (codes.is_contiguous() and base.is_contiguous()):
        raise ValueError("codes and base must be contiguous")
    from .build import load_library
    lib = load_library()
    nq, m, kc = tables.shape
    c = codes.shape[1]
    mode = _LUT_MODE[lut_dtype]
    smem = lib.qpad_pq_adc_gather_topk_smem(mode, m, kc, k)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a (M={m}, K={kc}) table with k={k} needs {smem} "
                         f"bytes of shared memory (limit {_SMEM_LIMIT})")
    if nq == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=base.device),
                torch.empty((0, k), dtype=torch.int64, device=base.device))
    qt, s = quantize_lut(tables, lut_dtype, scale)
    qt = qt.contiguous()
    s = s.to(torch.float32).contiguous()
    dev = base.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if c == 0:
        return out_d.fill_(float("inf")), out_i.long().fill_(-1)
    n_scratch = lib.qpad_pq_adc_gather_topk_scratch(nq, c, k)
    sk = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    ss = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qpad_pq_adc_gather_topk(
            qt.data_ptr(), mode, s.data_ptr(), codes.data_ptr(),
            base.data_ptr(), nq, c, m, kc, k, sk.data_ptr(), ss.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pq_adc_gather_topk launch failed: CUDA error "
                           f"{err}")
    pq_adc_gather_topk.launches += 1
    return out_d, out_i.long()


pq_adc_gather_topk.launches = 0
