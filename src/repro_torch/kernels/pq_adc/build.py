"""The ADC kernels' libraries: K1 (``csrc/pq_adc_gather_topk.cu``, its
gathered and cell-major entries) and K2
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
        _VP, _I32, _VP, _VP, _I32, _VP] + [_I32] * 7 + [_VP] * 5
    lib.qpad_pq_adc_gather_topk.restype = _I32
    lib.qpad_pq_adc_cells_topk.argtypes = [
        _VP, _I32, _VP, _VP, _I32, _VP, _VP, _VP, _VP, _VP, _VP] + \
        [_I32] * 10 + [_VP] * 5
    lib.qpad_pq_adc_cells_topk.restype = _I32
    lib.qpad_pq_adc_select_plan.argtypes = [_I32, _I32, _I32, _I32, _I64,
                                            _I64, _I32, _I32, _I32, _VP]
    lib.qpad_pq_adc_select_plan.restype = _I32
    lib.qpad_pq_adc_gather_topk_smem.argtypes = [_I32, _I32, _I32, _I32]
    lib.qpad_pq_adc_gather_topk_smem.restype = _I64


def _declare_topk(lib: ctypes.CDLL):
    lib.qpad_pq_adc_topk.argtypes = [
        _VP, _I32, _I32, _I64, _VP, _VP] + [_I32] * 9 + [_VP] * 5
    lib.qpad_pq_adc_topk.restype = _I32
    lib.qpad_pq_adc_topk_plan.argtypes = [_I32] * 9 + [_VP]
    lib.qpad_pq_adc_topk_plan.restype = _I32


def gather_topk_library() -> ctypes.CDLL:
    """K1's library (built at first use)."""
    return load_library(GATHER_TOPK_SOURCE, _declare_gather_topk)


def topk_library() -> ctypes.CDLL:
    """K2's library (built at first use)."""
    return load_library(TOPK_SOURCE, _declare_topk)
