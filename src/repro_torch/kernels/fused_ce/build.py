"""K6's library (``csrc/fused_ce_fwd.cu``), built at first use and loaded
through ``repro_torch.kernels.build``, with its C ABI declared here."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import load_library

__all__ = ["SOURCE", "library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_ce_fwd.cu"

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _declare(lib: ctypes.CDLL):
    lib.qpad_fused_ce_fwd.argtypes = (
        [_VP] * 5 + [_I32] * 9 + [_I64] * 4 + [_VP])
    lib.qpad_fused_ce_fwd.restype = _I32


def library() -> ctypes.CDLL:
    """K6's library (built at first use)."""
    return load_library(SOURCE, _declare)
