"""The ADC kernels' libraries: K1 (``csrc/pq_adc_gather_topk.cu``) and K2
(``csrc/pq_adc_topk.cu``), built at first use and loaded through
``repro_torch.kernels.build``, with their C ABI declared here."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import load_library

__all__ = ["GATHER_TOPK_SOURCE", "TOPK_SOURCE", "gather_topk_library",
           "topk_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
GATHER_TOPK_SOURCE = _CSRC / "pq_adc_gather_topk.cu"
TOPK_SOURCE = _CSRC / "pq_adc_topk.cu"

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _declare_gather_topk(lib: ctypes.CDLL):
    lib.qpad_pq_adc_gather_topk.argtypes = [
        _VP, _I32, _VP, _VP, _I32, _VP, _I32, _I32, _I32, _I32, _I32, _VP,
        _VP, _VP, _VP, _VP]
    lib.qpad_pq_adc_gather_topk.restype = _I32
    lib.qpad_pq_adc_gather_topk_scratch.argtypes = [_I32, _I32, _I32]
    lib.qpad_pq_adc_gather_topk_scratch.restype = _I64
    lib.qpad_pq_adc_gather_topk_smem.argtypes = [_I32, _I32, _I32, _I32]
    lib.qpad_pq_adc_gather_topk_smem.restype = _I64


def _declare_topk(lib: ctypes.CDLL):
    lib.qpad_pq_adc_topk.argtypes = [
        _VP, _I32, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _VP, _VP,
        _VP, _VP, _VP]
    lib.qpad_pq_adc_topk.restype = _I32
    lib.qpad_pq_adc_topk_scratch.argtypes = [_I32] * 6
    lib.qpad_pq_adc_topk_scratch.restype = _I64
    lib.qpad_pq_adc_topk_smem.argtypes = [_I32] * 4
    lib.qpad_pq_adc_topk_smem.restype = _I64


def gather_topk_library() -> ctypes.CDLL:
    """K1's library (built at first use)."""
    return load_library(GATHER_TOPK_SOURCE, _declare_gather_topk)


def topk_library() -> ctypes.CDLL:
    """K2's library (built at first use)."""
    return load_library(TOPK_SOURCE, _declare_topk)
