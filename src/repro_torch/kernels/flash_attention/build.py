"""K5's libraries, built at first use and loaded through
``repro_torch.kernels.build``, with their C ABI declared here: the bf16
tensor-core kernel (``csrc/flash_attention_bf16.cu``) and the f32
CUDA-core kernel (``csrc/flash_attention_fwd.cu``)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import load_library

__all__ = ["SOURCE", "BF16_SOURCE", "library", "bf16_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "flash_attention_fwd.cu"
BF16_SOURCE = _CSRC / "flash_attention_bf16.cu"

_VP, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)


# both kernels take (q, k, v, out, B, S, H, KV, dh, window, scale, the nine
# strides, stream)
_ARGTYPES = ([_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _F32]
             + [_I64] * 9 + [_VP])


def _declare(lib: ctypes.CDLL):
    lib.qpad_flash_attention_fwd.argtypes = _ARGTYPES
    lib.qpad_flash_attention_fwd.restype = _I32


def _declare_bf16(lib: ctypes.CDLL):
    lib.qpad_flash_attention_bf16.argtypes = _ARGTYPES
    lib.qpad_flash_attention_bf16.restype = _I32


def library() -> ctypes.CDLL:
    """K5's f32 library (built at first use)."""
    return load_library(SOURCE, _declare)


def bf16_library() -> ctypes.CDLL:
    """K5's bf16 tensor-core library (built at first use)."""
    return load_library(BF16_SOURCE, _declare_bf16)
