"""PyTorch / CUDA port of the QPAD vector-search system.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core``, ``kernels``, ``search``) and imports nothing of it. Entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
"""
from .core import MPADConfig, fit_mpad
from .search import SearchEngine, ServeConfig, build_engine, parse_spec

__all__ = ["MPADConfig", "fit_mpad", "SearchEngine", "ServeConfig",
           "build_engine", "parse_spec"]
