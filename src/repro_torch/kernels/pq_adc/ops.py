"""Wrappers of the ADC top-k kernels: K1 (fused ADC-gather top-k over
per-query candidate codes) and K2 (ADC top-k over one shared code matrix).

Each wrapper takes its plain PyTorch version (``ref.py``) for tensors on
the CPU, and only for those; for CUDA tensors it launches its CUDA kernel
(``csrc/``) or raises. Each launch adds one to the wrapper's ``launches``.

Contract (both routes): (d2 (Q, k) f32 ascending, slot or row (Q, k)
int64) with ties to the lower slot and (+inf, -1) where fewer than k
candidates are finite (k above the candidate count pads the same way).
"""
from __future__ import annotations

import torch

from .build import gather_topk_library, topk_library
from .lut import LUT_DTYPES, quantize_lut
from .ref import pq_adc_gather_topk_ref, pq_adc_topk_ref

__all__ = ["pq_adc_gather_topk", "pq_adc_gather_topk_plain", "pq_adc_topk",
           "pq_adc_topk_plain", "MAX_K"]

MAX_K = 8192                     # the kernels' largest chunk holds 2k pairs
_LUT_MODE = {"f32": 0, "bf16": 1, "int8": 2}
_SMEM_LIMIT = 232_448            # bytes of shared memory a Hopper block may use


def _pad_contract(d2, idx, k):
    """(+inf, -1) in unfilled slots and right-padding up to k."""
    idx = torch.where(d2 == float("inf"), -1, idx)
    if d2.shape[1] < k:
        pad = k - d2.shape[1]
        d2 = torch.nn.functional.pad(d2, (0, pad), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return d2, idx


def pq_adc_gather_topk_plain(tables, codes, base, k, lut_dtype="f32",
                             scale=None):
    """K1's plain PyTorch version under the kernel's contract: ``ref.py``'s
    top-k, with (+inf, -1) in unfilled slots and k > C padded. Runs on any
    device; the wrapper takes it for CPU tensors."""
    d2, slot = pq_adc_gather_topk_ref(tables, codes, base,
                                      min(k, codes.shape[1]), lut_dtype,
                                      scale)
    return _pad_contract(d2, slot, k)


def pq_adc_topk_plain(tables, codes, k, lut_dtype="f32", scale=None):
    """K2's plain PyTorch version under the kernel's contract: ``ref.py``'s
    shared-codes top-k, with (+inf, -1) in unfilled slots and k > N
    padded. Runs on any device; the wrapper takes it for CPU tensors."""
    d2, row = pq_adc_topk_ref(tables, codes, min(k, codes.shape[0]),
                              lut_dtype, scale)
    return _pad_contract(d2, row, k)


def _check_common(tables, k, lut_dtype, scale, *others):
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"unknown lut_dtype {lut_dtype!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    devs = {t.device for t in (tables, *others)}
    if scale is not None:
        devs.add(torch.as_tensor(scale).device)
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


_CODE_DTYPES = (torch.uint8, torch.int32)


def _check_cuda_codes(tables, codes):
    """What both kernels take: CUDA tensors, contiguous uint8 codes (K <=
    256) or int32 codes (K > 256)."""
    if tables.device.type != "cuda":
        raise ValueError(f"no kernel for device {tables.device}")
    if codes.dtype not in _CODE_DTYPES:
        raise TypeError(f"codes must be uint8 or int32, got {codes.dtype}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")


def _check_smem(smem, m, kc, k):
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a (M={m}, K={kc}) table with k={k} needs {smem} "
                         f"bytes of shared memory (limit {_SMEM_LIMIT})")


def _empty(nq, k, dev):
    return (torch.full((nq, k), float("inf"), dtype=torch.float32,
                       device=dev),
            torch.full((nq, k), -1, dtype=torch.int64, device=dev))


def _quantized(tables, lut_dtype, scale):
    qt, s = quantize_lut(tables, lut_dtype, scale)
    return qt.contiguous(), s.to(torch.float32).contiguous()


def pq_adc_gather_topk(tables: torch.Tensor, codes: torch.Tensor,
                       base: torch.Tensor, k: int, lut_dtype: str = "f32",
                       scale=None):
    """Fused ADC scan over per-query candidate codes plus top-k (K1).

    tables (Q, M, K) f32, quantized here per ``lut_dtype`` with
    ``quantize_lut`` (``scale`` optionally overrides the per-query int8
    scale with a caller-certified bound); codes (Q, C, M) uint8 (int32
    for K > 256); base (Q, C) f32, +inf masking pads. Returns (d2 (Q, k)
    f32, slot (Q, k) int64).
    """
    _check_common(tables, k, lut_dtype, scale, codes, base)
    if tables.ndim != 3 or codes.ndim != 3 or base.ndim != 2:
        raise ValueError("expected tables (Q, M, K), codes (Q, C, M), "
                         "base (Q, C)")
    nq, m, kc = tables.shape
    if codes.shape[0] != nq or codes.shape[2] != m or \
            tuple(base.shape) != tuple(codes.shape[:2]):
        raise ValueError(f"shape mismatch: tables {tuple(tables.shape)}, "
                         f"codes {tuple(codes.shape)}, base "
                         f"{tuple(base.shape)}")
    if tables.device.type == "cpu":
        return pq_adc_gather_topk_plain(tables, codes, base, k, lut_dtype,
                                        scale)
    _check_cuda_codes(tables, codes)
    if base.dtype != torch.float32:
        raise TypeError(f"base must be float32, got {base.dtype}")
    if not base.is_contiguous():
        raise ValueError("base must be contiguous")
    lib = gather_topk_library()
    mode = _LUT_MODE[lut_dtype]
    _check_smem(lib.qpad_pq_adc_gather_topk_smem(mode, m, kc, k), m, kc, k)
    c = codes.shape[1]
    dev = base.device
    if nq == 0 or c == 0:
        return _empty(nq, k, dev)
    qt, s = _quantized(tables, lut_dtype, scale)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    n_scratch = lib.qpad_pq_adc_gather_topk_scratch(nq, c, k)
    sk = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    ss = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qpad_pq_adc_gather_topk(
            qt.data_ptr(), mode, s.data_ptr(), codes.data_ptr(),
            codes.element_size(), base.data_ptr(), nq, c, m, kc, k, sk.data_ptr(), ss.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pq_adc_gather_topk launch failed: CUDA error "
                           f"{err}")
    pq_adc_gather_topk.launches += 1
    return out_d, out_i.long()


pq_adc_gather_topk.launches = 0


def pq_adc_topk(tables: torch.Tensor, codes: torch.Tensor, k: int,
                lut_dtype: str = "f32", scale=None):
    """ADC scan over one shared code matrix plus top-k (K2).

    tables (Q, M, K) f32, quantized here per ``lut_dtype`` as in
    ``pq_adc_gather_topk``; codes (N, M) uint8 (int32 for K > 256),
    scanned by every query.
    Returns (d2 (Q, k) f32 ascending, row (Q, k) int64).
    """
    _check_common(tables, k, lut_dtype, scale, codes)
    if tables.ndim != 3 or codes.ndim != 2:
        raise ValueError("expected tables (Q, M, K) and codes (N, M)")
    nq, m, kc = tables.shape
    if codes.shape[1] != m:
        raise ValueError(f"shape mismatch: tables {tuple(tables.shape)}, "
                         f"codes {tuple(codes.shape)}")
    if tables.device.type == "cpu":
        return pq_adc_topk_plain(tables, codes, k, lut_dtype, scale)
    _check_cuda_codes(tables, codes)
    lib = topk_library()
    mode = _LUT_MODE[lut_dtype]
    _check_smem(lib.qpad_pq_adc_topk_smem(mode, m, kc, k), m, kc, k)
    n = codes.shape[0]
    dev = codes.device
    if nq == 0 or n == 0:
        return _empty(nq, k, dev)
    qt, s = _quantized(tables, lut_dtype, scale)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        n_scratch = lib.qpad_pq_adc_topk_scratch(mode, nq, n, m, kc, k)
        sk = torch.empty(n_scratch, dtype=torch.float32, device=dev)
        ss = torch.empty(n_scratch, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qpad_pq_adc_topk(
            qt.data_ptr(), mode, s.data_ptr(), codes.data_ptr(),
            codes.element_size(), nq, n, m, kc, k, sk.data_ptr(), ss.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pq_adc_topk launch failed: CUDA error {err}")
    pq_adc_topk.launches += 1
    return out_d, out_i.long()


pq_adc_topk.launches = 0
