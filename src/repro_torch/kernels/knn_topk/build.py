"""K3's library (``csrc/knn_topk.cu``, which includes the shared
``pq_adc/csrc/topk_select.cuh``), built at first use and loaded through
``repro_torch.kernels.build``, with its C ABI declared here."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import load_library

__all__ = ["SOURCE", "library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "knn_topk.cu"

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _declare(lib: ctypes.CDLL):
    lib.qpad_knn_topk.argtypes = ([_VP, _VP] + [_I32] * 5 + [_VP, _VP, _I64]
                                  + [_VP] * 3)
    lib.qpad_knn_topk.restype = _I32
    lib.qpad_knn_topk_scratch.argtypes = [_I32] * 5
    lib.qpad_knn_topk_scratch.restype = _I64


def library() -> ctypes.CDLL:
    """K3's library (built at first use)."""
    return load_library(SOURCE, _declare)
