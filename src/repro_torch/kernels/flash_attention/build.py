"""K5's library (``csrc/flash_attention_fwd.cu``), built at first use and
loaded through ``repro_torch.kernels.build``, with its C ABI declared
here."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import load_library

__all__ = ["SOURCE", "library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"

_VP, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)


def _declare(lib: ctypes.CDLL):
    lib.qpad_flash_attention_fwd.argtypes = (
        [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _F32]
        + [_I64] * 9 + [_VP])
    lib.qpad_flash_attention_fwd.restype = _I32


def library() -> ctypes.CDLL:
    """K5's library (built at first use)."""
    return load_library(SOURCE, _declare)
