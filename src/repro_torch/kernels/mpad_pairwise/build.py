"""K4's library (``csrc/pairwise_stats.cu``), built at first use and loaded
through ``repro_torch.kernels.build``, with its C ABI declared here."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import load_library

__all__ = ["SOURCE", "library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "pairwise_stats.cu"

_VP, _I32 = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL):
    lib.qpad_pairwise_stats.argtypes = [_VP, _VP, _I32, _VP, _VP, _VP, _VP,
                                        _VP, _VP, _VP]
    lib.qpad_pairwise_stats.restype = _I32
    lib.qpad_pairwise_stats_scratch.argtypes = [
        _I32, ctypes.POINTER(ctypes.c_longlong)]
    lib.qpad_pairwise_stats_scratch.restype = None


def library() -> ctypes.CDLL:
    """K4's library (built at first use)."""
    return load_library(SOURCE, _declare)
