"""Sharding over a ``torch.distributed`` mesh, one process a rank (the
port of ``repro.parallel``).

* ``context``: the ``Mesh`` record (1-D for serving, N-D for the model
  side), ``mesh_context`` / ``active_mesh`` / ``require_mesh``,
  ``constrain``, and the collectives over an axis or a tuple of axes,
  with the differentiable ones the model side runs through.
* ``sharding``: the partition specs (``P``), the blocks they give each
  rank (``rank_block``, ``gather_blocks``), the serving state's split
  markers and JAX's spec sets: the LM's
  (``lm_param_specs``, ``opt_specs``, ``zero_opt_specs``,
  ``lm_cache_specs``), GIN's and the recommenders'.
* ``engine``: the serving state's layout pass (``shard_engine``,
  ``shard_stream``).
* ``step``: the rank programs over blocks: the LM train step (expert
  parallelism on the MoE layers, the ZeRO-1 update), the LM prefill and
  decode over a split KV cache, and the other families' steps.

``engine``, ``sharding`` and ``step`` import the search package or the
models, which import ``context``; they load at first use of their names
here.
"""
import importlib

from .context import (Mesh, active_mesh, all_gather, all_reduce_max,
                      all_reduce_min, all_reduce_sum, constrain, mesh_context,
                      require_mesh)

__all__ = ["Mesh", "active_mesh", "mesh_context", "require_mesh",
           "constrain", "all_gather", "all_reduce_min", "all_reduce_max",
           "all_reduce_sum", "shard_engine", "shard_stream", "dp_axes",
           "engine_state_specs", "lm_param_specs", "opt_specs",
           "zero_opt_specs", "tree_named", "lm_cache_specs",
           "replicate_like", "make_sharded_train_step",
           "make_sharded_prefill", "make_sharded_decode_step"]

_LAZY = {"shard_engine": "engine", "shard_stream": "engine",
         "dp_axes": "sharding", "engine_state_specs": "sharding",
         "lm_param_specs": "sharding", "opt_specs": "sharding",
         "zero_opt_specs": "sharding", "tree_named": "sharding",
         "lm_cache_specs": "sharding", "replicate_like": "sharding",
         "make_sharded_train_step": "step", "make_sharded_prefill": "step",
         "make_sharded_decode_step": "step"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
