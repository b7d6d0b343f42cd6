"""Build and load the CUDA sources of the ADC kernels.

``nvcc`` compiles ``csrc/pq_adc_gather_topk.cu`` for ``sm_90a`` into a
shared library with a plain C interface, which ``ctypes`` loads (no
PyTorch headers, so a build takes seconds). The library is built at first
use from the sources in the checkout only, into ``build/repro_torch_kernels/``
at the root of the checkout (listed in ``.gitignore``), under a name keyed
by the source's content: an edited source is rebuilt, an unchanged one is
loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

__all__ = ["SOURCE", "BUILD_DIR", "NVCC_FLAGS", "build_library",
           "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "pq_adc_gather_topk.cu"
# src/repro_torch/kernels/pq_adc/build.py -> the checkout's root
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build_library(verbose: bool = False) -> Path:
    """Compile the source unless a library of the same content exists;
    returns its path. ``verbose`` adds ``-Xptxas -v`` and prints what
    ptxas reports (registers, shared memory, spills)."""
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libqpad_pq_adc_{digest}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        os.replace(tmp, out)           # atomic: readers never see a partial
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """Build at first use, load once per process, declare the C ABI."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qpad_pq_adc_gather_topk.argtypes = [
        vp, i32, vp, vp, vp, i32, i32, i32, i32, i32, vp, vp, vp, vp, vp]
    lib.qpad_pq_adc_gather_topk.restype = i32
    lib.qpad_pq_adc_gather_topk_scratch.argtypes = [i32, i32, i32]
    lib.qpad_pq_adc_gather_topk_scratch.restype = i64
    lib.qpad_pq_adc_gather_topk_smem.argtypes = [i32, i32, i32, i32]
    lib.qpad_pq_adc_gather_topk_smem.restype = i64
    _lib = lib
    return lib
