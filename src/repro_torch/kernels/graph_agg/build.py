"""The aggregate's library (``csrc/csr_gather_sum.cu``), built at first use
and loaded through ``repro_torch.kernels.build``, with its C ABI declared
here."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import load_library

__all__ = ["SOURCE", "library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "csr_gather_sum.cu"

_VP, _I32 = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL):
    lib.qpad_csr_gather_sum.argtypes = [_VP] * 5 + [_I32] * 3 + [_VP, _VP]
    lib.qpad_csr_gather_sum.restype = _I32


def library() -> ctypes.CDLL:
    """The aggregate's library (built at first use)."""
    return load_library(SOURCE, _declare)
