"""Sharded serving over a ``torch.distributed`` mesh, one process a shard
(the port of ``repro.parallel``'s serving part): the ``Mesh`` record and
its collectives (``context``), the split markers (``sharding``) and the
layout pass (``engine``). The LM, recsys and gnn spec sets, ``constrain``
and ``make_production_mesh`` belong to the model side (ROADMAP.md item
13).

``engine`` and ``sharding`` import the search package, which imports
``context``; they load at first use of their names here.
"""
import importlib

from .context import (Mesh, active_mesh, all_gather, all_reduce_min,
                      all_reduce_sum, mesh_context, require_mesh)

__all__ = ["Mesh", "active_mesh", "mesh_context", "require_mesh",
           "all_gather", "all_reduce_min", "all_reduce_sum", "shard_engine",
           "shard_stream", "dp_axes", "engine_state_specs",
           "replicate_like"]

_LAZY = {"shard_engine": "engine", "shard_stream": "engine",
         "dp_axes": "sharding", "engine_state_specs": "sharding",
         "replicate_like": "sharding"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
