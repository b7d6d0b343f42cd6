"""K6's libraries, built at first use and loaded through
``repro_torch.kernels.build``, with their C ABI declared here: the bf16
tensor-core kernel (``csrc/fused_ce_bf16.cu``) and the f32 / mixed-dtype
CUDA-core kernel (``csrc/fused_ce_fwd.cu``)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import load_library

__all__ = ["SOURCE", "BF16_SOURCE", "library", "bf16_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "fused_ce_fwd.cu"
BF16_SOURCE = _CSRC / "fused_ce_bf16.cu"

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _declare(lib: ctypes.CDLL):
    lib.qpad_fused_ce_fwd.argtypes = (
        [_VP] * 5 + [_I32] * 9 + [_I64] * 4 + [_VP])
    lib.qpad_fused_ce_fwd.restype = _I32


def _declare_bf16(lib: ctypes.CDLL):
    lib.qpad_fused_ce_bf16.argtypes = (
        [_VP] * 5 + [_I32] * 8 + [_I64] * 2 + [_VP])
    lib.qpad_fused_ce_bf16.restype = _I32


def library() -> ctypes.CDLL:
    """K6's f32 library (built at first use)."""
    return load_library(SOURCE, _declare)


def bf16_library() -> ctypes.CDLL:
    """K6's bf16 tensor-core library (built at first use)."""
    return load_library(BF16_SOURCE, _declare_bf16)
