"""Build and load the port's CUDA sources (one helper for every kernel
package).

``nvcc`` compiles each ``csrc/*.cu`` source for ``sm_90a`` into its own
shared library with a plain C interface, which ``ctypes`` loads (no
PyTorch headers, so a build takes seconds). A library is built at first
use from the sources in the checkout only, into ``build/repro_torch_kernels/``
at the root of the checkout (listed in ``.gitignore``), under a name keyed
by the content of the source and of the ``*.cuh`` headers beside it: an
edited source is rebuilt, an unchanged one is loaded as it is.
``build_libraries`` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Iterable, List

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "library_path",
           "build_libraries", "load_library"]

_KERNELS = Path(__file__).resolve().parent
# src/repro_torch/kernels/build.py -> the checkout's root
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# every CUDA source of the port (K1, K2, K4, K5, K6), one library each
SOURCES = tuple(sorted(_KERNELS.glob("*/csrc/*.cu")))

_loaded: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(source: Path) -> Path:
    """Where ``source``'s library lives: named by the hash of the source
    and of the headers in its directory."""
    h = hashlib.sha1(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"libqpad_{source.stem}_{h.hexdigest()[:12]}.so"


def build_libraries(sources: Iterable[Path] = SOURCES,
                    verbose: bool = False) -> List[Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; returns the libraries' paths. ``verbose``
    rebuilds all of them with ``-Xptxas -v`` and prints what ptxas
    reports (registers, shared memory, spills)."""
    sources = [Path(s) for s in sources]
    outs = [library_path(s) for s in sources]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src, out in zip(sources, outs):
            if out.exists() and not verbose:
                continue
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS,
                   *(("-Xptxas", "-v") if verbose else ()), "-o", tmp,
                   str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((cmd, proc, tmp, out))
        failed = []
        for cmd, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{log}")
                continue
            if verbose:
                print(f"{out.name}:\n{log}", flush=True)
            os.replace(tmp, out)       # atomic: readers never see a partial
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def load_library(source: Path,
                 declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build ``source`` at first use, load it once per process and let
    ``declare`` set the C ABI (argtypes and restype) of its functions."""
    lib = _loaded.get(source)
    if lib is None:
        (path,) = build_libraries([source])
        lib = ctypes.CDLL(str(path))
        declare(lib)
        _loaded[source] = lib
    return lib
