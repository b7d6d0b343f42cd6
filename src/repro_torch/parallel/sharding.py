"""Partition specs and the blocks they give each rank (port of
``repro.parallel.sharding``).

Axis conventions (the JAX package's):
  pod   -- outer data parallelism across pods
  data  -- data parallelism within a pod
  model -- tensor / expert / vocab / sequence parallelism

A spec (``P``, the port's ``PartitionSpec``) holds one entry a dim:
``None`` (whole), an axis name, or a tuple of axis names (the dim split
over all of them, the first the outermost). Where JAX places a leaf by its
spec over a device mesh, each of the port's ranks keeps the block the
spec gives it (``rank_block``: JAX's ``NamedSharding`` blocks, in its
device order), and ``gather_blocks`` puts the full leaf back together.
The spec sets are JAX's, entry for entry: the LM's (``lm_param_specs``,
``opt_specs``, the ZeRO-1 ``zero_opt_specs``, ``lm_cache_specs``), GIN's
and the four recommenders'.

The serving state keeps its split markers: ``ROWS`` and ``CELLS`` split
dim 0 into per-rank blocks of a 1-D mesh (corpus rows, row-major codes,
or cells of the cell-major posting structures), ``REPLICATED`` keeps the
leaf whole on every rank (``engine_state_specs``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch._tree import tree_map
from repro_torch.search.registry import CELLS, REPLICATED, ROWS

from .context import DP_AXES, Mesh, all_gather

__all__ = ["P", "NamedSharding", "dp_axes", "tree_named", "replicate_like",
           "engine_state_specs", "lm_param_specs", "opt_specs",
           "zero_opt_specs", "batch_axes", "lm_cache_specs",
           "gin_param_specs",
           "sasrec_param_specs", "dien_param_specs", "autoint_param_specs",
           "twotower_param_specs", "rank_block", "gather_blocks",
           "shard_tree", "gather_tree", "ROWS", "CELLS", "REPLICATED"]


class P:
    """A partition spec: one entry a dim, each ``None``, an axis name or a
    tuple of axis names (a one-name tuple is kept as the name, as JAX's
    ``PartitionSpec`` keeps it). Iterates, indexes and compares equal to
    the tuple of its entries; a leaf of the port's trees (not a tuple)."""
    __slots__ = ("_entries",)

    def __init__(self, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                if not e or not all(isinstance(a, str) for a in e):
                    raise ValueError(f"a spec entry {e!r}")
                e = e[0] if len(e) == 1 else tuple(e)
            elif e is not None and not isinstance(e, str):
                raise ValueError(f"a spec entry {e!r}")
            norm.append(e)
        self._entries = tuple(norm)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self._entries == other._entries
        if isinstance(other, tuple):
            return self._entries == other
        return NotImplemented

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return f"P{self._entries!r}" if len(self) != 1 \
            else f"P({self._entries[0]!r})"


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (JAX's ``NamedSharding``): where each rank's
    block of a leaf comes from (``rank_block(mesh, leaf, spec)``)."""
    mesh: Mesh
    spec: P


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of ``mesh``: ``("pod", "data")`` on a
    multi-pod mesh, ``("data",)`` else."""
    return tuple(a for a in mesh.axis_names if a in DP_AXES)


def tree_named(mesh: Mesh, spec_tree: Any) -> Any:
    """A spec tree -> the same tree of ``NamedSharding``s over ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def replicate_like(tree: Any) -> Any:
    """``P()`` (whole on every rank) for every leaf of ``tree``."""
    return tree_map(lambda _: P(), tree)


# ------------------------------------------------------------- blocks

def rank_block(mesh, leaf, marker, copy: bool = False):
    """This rank's block of ``leaf``.

    Under a spec ``P``: each dim split over its entry's axes into equal
    blocks, this rank taking the block at its index along them
    (``Mesh.axis_index``: a dim over (a1, a2) takes block c(a1) * |a2| +
    c(a2), JAX's ``NamedSharding`` order), as a copy; a dim that does not
    divide raises. ``P()`` (and a spec that splits nothing) gives a copy
    of the whole leaf too: a block never shares memory with ``leaf``, so an
    in-place step on the blocks leaves the tree they came from as it was.

    Under a serving marker: a ``ROWS`` or ``CELLS`` leaf's dim 0 cut into
    ``mesh.size`` equal blocks (a copy, so the whole tensor can be freed);
    a ``REPLICATED`` leaf passes through, and so does a split one on a
    mesh of one rank unless ``copy``."""
    if isinstance(marker, P):
        return _spec_block(mesh, leaf, marker)
    if marker not in (ROWS, CELLS) or (mesh.size == 1 and not copy):
        return leaf
    n = leaf.shape[0]
    if n % mesh.size:
        raise ValueError(f"dim 0 of a split leaf ({n}) is not a multiple "
                         f"of the {mesh.size} ranks")
    per = n // mesh.size
    return leaf[mesh.rank * per:(mesh.rank + 1) * per].clone()


def _spec_dims(spec: P, ndim: int):
    """[(dim, axes)] of the dims ``spec`` splits (its entries not None)."""
    if len(spec) > ndim:
        raise ValueError(f"a spec of {len(spec)} entries ({spec!r}) for a "
                         f"{ndim}-d leaf")
    return [(d, _entry_axes(e)) for d, e in enumerate(spec) if e is not None]


def _spec_block(mesh, leaf, spec: P):
    out = leaf
    for dim, axes in _spec_dims(spec, leaf.dim()):
        n = mesh.axis_size(axes)
        if n == 1:
            continue
        if leaf.shape[dim] % n:
            raise ValueError(f"dim {dim} ({leaf.shape[dim]}) of a leaf "
                             f"under {spec!r} is not a multiple of the {n} "
                             f"ranks along {axes}")
        per = leaf.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(axes) * per, per)
    return out.clone(memory_format=torch.contiguous_format)


def gather_blocks(mesh: Mesh, block: torch.Tensor,
                  spec: P) -> torch.Tensor:
    """The full leaf from the ranks' blocks under ``spec`` (collective:
    every rank of each split dim's axes takes part), the inverse of
    ``rank_block``. The result is a tensor of its own, also where no
    collective runs (a leaf no axis of size > 1 splits): a later in-place
    step on the blocks does not change it, as JAX's gathered arrays hold
    values."""
    out = block
    for dim, axes in _spec_dims(spec, block.dim()):
        if mesh.axis_size(axes) > 1:
            out = all_gather(mesh, out, dim, axes)
    return out.clone() if out is block else out


def shard_tree(mesh: Mesh, tree: Any, specs: Any) -> Any:
    """This rank's block of every leaf of ``tree`` under ``specs``."""
    return tree_map(lambda leaf, s: rank_block(mesh, leaf, s), tree, specs)


def gather_tree(mesh: Mesh, tree: Any, specs: Any) -> Any:
    """The full leaves of a tree of this rank's blocks (collective)."""
    return tree_map(lambda b, s: gather_blocks(mesh, b, s), tree, specs)


# ------------------------------------------------------------- serving

def engine_state_specs(state, axis: str = "data"):
    """A ``ShardedEngineState`` -> the same structure of split markers:
    the corpus rows split, the reducer replicated (the ``Reducer`` whole),
    ``n_real`` replicated, the kind's payload marked by the registry
    (``IndexOps.payload_specs``)."""
    from repro_torch.search.registry import Index, get_ops
    return type(state)(
        corpus=ROWS,
        proj=None if state.proj is None else REPLICATED,
        n_real=REPLICATED,
        index=Index(state.index.kind, get_ops(state.index.kind).payload_specs(
            state.index.payload, axis)))


# -------------------------------------------------------------------- LM

def _run_specs(moe: bool) -> dict:
    base = {
        "ln1": P(None, None),
        "ln2": P(None, None),
        "wq": P(None, None, "model"),
        "wk": P(None, None, "model"),
        "wv": P(None, None, "model"),
        "wo": P(None, "model", None),
    }
    if moe:
        base["moe"] = {
            "router": P(None, None, "model"),
            "w_gate": P(None, "model", None, None),
            "w_up": P(None, "model", None, None),
            "w_down": P(None, "model", None, None),
        }
    else:
        base.update({
            "w_gate": P(None, None, "model"),
            "w_up": P(None, None, "model"),
            "w_down": P(None, "model", None),
        })
    return base


def lm_param_specs(cfg) -> Any:
    """The specs of ``transformer.lm_init_params(cfg)``'s tree: attention
    projections split on the fused heads * dh dim over "model", the MoE
    router and experts on the expert dim, the embedding (and an untied
    head) on the vocabulary."""
    from repro_torch.models.transformer import layer_runs
    specs = {
        "embed": P("model", None),
        "final_norm": P(None),
        "runs": [_run_specs(cfg.moe is not None) for _ in layer_runs(cfg)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "model")
    return specs


def opt_specs(param_specs) -> Any:
    """Adam moments split exactly like their parameters."""
    return {"step": P(), "m": tree_map(lambda s: s, param_specs),
            "v": tree_map(lambda s: s, param_specs)}


def _dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def batch_axes(mesh, batch: int):
    """The axes JAX's arch builders split ``batch`` rows over: the data
    axes when their size divides it (and is at most it), else None."""
    size = _dp_size(mesh)
    return dp_axes(mesh) if (batch % size == 0 and batch >= size) else None


def zero_opt_specs(params_abstract, param_specs, mesh) -> Any:
    """ZeRO-1 optimizer-state specs: each Adam moment additionally splits
    its first unsplit dim that the data-parallel size divides (and is at
    least) over the data axes; a leaf with no such dim keeps its
    parameter's spec. The update then all-gathers fresh parameter blocks
    over the data axes (``optim.adamw.sharded_adamw_update``).
    ``params_abstract`` needs only each leaf's ``shape`` (the full
    leaf's)."""
    dp = dp_axes(mesh)
    dp_size = _dp_size(mesh)

    def moment_spec(leaf, spec):
        if dp_size == 1:
            return spec
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, (dim, entry) in enumerate(zip(leaf.shape, entries)):
            if entry is None and dim % dp_size == 0 and dim >= dp_size:
                entries[i] = dp
                return P(*entries)
        return spec

    mom = tree_map(moment_spec, params_abstract, param_specs)
    return {"step": P(), "m": mom, "v": tree_map(lambda s: s, mom)}


def lm_cache_specs(cfg, mesh, batch: int, max_len: int) -> Any:
    """Per-run KV cache specs: the batch split over the data axes when
    they divide it; a run's cache of 8192 slots or more split on its
    sequence over "model" (over every axis when the batch is not split,
    if they divide it); shorter (window) caches whole."""
    from repro_torch.models.transformer import layer_runs
    dp = dp_axes(mesh)
    dp_size = _dp_size(mesh)
    model_size = mesh.shape.get("model", 1)
    specs = []
    for kind, _ in layer_runs(cfg):
        s_run = (min(cfg.sliding_window, max_len)
                 if kind == "local" and cfg.sliding_window else max_len)
        if batch % dp_size == 0 and batch >= dp_size:
            b_ax, seq_candidates = dp, ("model",)
        else:
            b_ax, seq_candidates = None, dp + ("model",)
        seq_ax = None
        total = 1
        for a in seq_candidates:
            total *= mesh.shape[a]
        if s_run >= 8192 and s_run % total == 0:
            seq_ax = seq_candidates
        elif s_run >= 8192 and s_run % model_size == 0:
            seq_ax = "model"
        specs.append({
            "k": P(None, b_ax, seq_ax, None, None),
            "v": P(None, b_ax, seq_ax, None, None),
            "pos": P(None),
        })
    return specs


# ------------------------------------------------------------------- GNN

def gin_param_specs(params) -> Any:
    """GIN is tiny (64-wide): every leaf whole on every rank."""
    return replicate_like(params)


# ---------------------------------------------------------------- recsys

def sasrec_param_specs(params) -> Any:
    sp = replicate_like(params)
    sp["item_emb"] = P("model", None)
    return sp


def dien_param_specs(params) -> Any:
    sp = replicate_like(params)
    sp["item_emb"] = P("model", None)
    sp["cat_emb"] = P("model", None)
    return sp


def autoint_param_specs(params) -> Any:
    sp = replicate_like(params)
    sp["emb"] = P("model", None)
    return sp


def twotower_param_specs(params) -> Any:
    sp = replicate_like(params)
    sp["user_emb"] = P("model", None)
    sp["item_emb"] = P("model", None)
    return sp
