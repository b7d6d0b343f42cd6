"""Checkpointing: atomic and retention-managed (port of
``repro.runtime.checkpoint``).

A checkpoint is one flat ``{keypath: np.ndarray}`` npz file named
``ckpt_%010d.npz``, keyed by the ``jax.tree_util.keystr`` path of each
leaf of the same tree (``['params']['embed']``, ``['opt']['step']``, ...).
Writes go to a temp file, are fsynced, and are renamed into place with
``os.replace``: a crash mid-write never corrupts the latest good step.

numpy has no bfloat16, so a bf16 leaf is stored as its uint16 bit
pattern and restored by the template's dtype, bit for bit. A bf16 leaf the
JAX package wrote (``np.asarray`` of a bf16 array, which ``np.load`` reads
back as the two-byte void dtype ``|V2``) is read into a bf16 template the
same way, bit for bit.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch._tree import keyed_leaves, tree_unflatten

__all__ = ["save_checkpoint", "save_arrays", "restore_checkpoint",
           "restore_resharded", "latest_checkpoint", "checkpoint_step"]

_STEP_RE = re.compile(r"ckpt_(\d+)\.npz$")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, leaf):
    """``arr`` as a leaf like ``leaf`` (its dtype, and its device for a
    tensor)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(arr, leaf.dtype)
    if leaf.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and \
            arr.dtype.kind in "uV":          # the port's uint16, JAX's |V2
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(leaf.dtype)
    return t.to(leaf.device)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in keyed_leaves(tree)}


def save_arrays(ckpt_dir: str, step: int, arrays: Dict[str, np.ndarray],
                keep: int = 3, protect: Iterable[str] = ()) -> str:
    """Write an already-flattened ``{keypath: array}`` mapping as one
    checkpoint file (the same atomic commit and retention as
    ``save_checkpoint``). ``protect`` names checkpoint basenames that
    retention must never unlink."""
    os.makedirs(ckpt_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())                 # bytes down before the name
        final = os.path.join(ckpt_dir, f"ckpt_{step:010d}.npz")
        os.replace(tmp, final)                   # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _apply_retention(ckpt_dir, keep, protect=protect)
    return final


def save_checkpoint(ckpt_dir: str, step: int, state: Any, keep: int = 3,
                    protect: Iterable[str] = ()) -> str:
    return save_arrays(ckpt_dir, step, _flatten(state), keep=keep,
                       protect=protect)


def _apply_retention(ckpt_dir: str, keep: int, protect: Iterable[str] = ()):
    protect = frozenset(protect)
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if _STEP_RE.search(f))
    for f in ckpts[:-keep] if keep else []:
        if f not in protect:
            os.unlink(os.path.join(ckpt_dir, f))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if _STEP_RE.search(f))
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def checkpoint_step(path: str) -> int:
    m = _STEP_RE.search(path)
    return int(m.group(1)) if m else -1


def restore_checkpoint(path: str, template: Any,
                       overlay: Optional[str] = None) -> Any:
    """Restore into the structure of ``template`` (shapes must match; each
    leaf takes the template leaf's dtype and device). ``overlay`` names a
    second (delta) checkpoint whose keys win over ``path``."""
    over = {}
    if overlay is not None:
        with np.load(overlay) as d:
            over = {k: d[k] for k in d.files}
    leaves = []
    with np.load(path) as data:
        for key, leaf in keyed_leaves(template):
            arr = over[key] if key in over else data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch at {key}: "
                    f"ckpt {arr.shape} vs template {tuple(leaf.shape)}")
            leaves.append(_from_numpy(arr, leaf))
    return tree_unflatten(template, leaves)


def restore_resharded(path: str, template: Any, splits: Any, mesh,
                      overlay: Optional[str] = None) -> Any:
    """Restore onto a serving mesh (elastic scaling): checkpoints are
    shard-agnostic, so every rank reads the whole file and keeps, for
    each leaf that ``splits`` (a tree congruent with ``template`` of the
    markers ``"rows"`` / ``"cells"`` / ``"replicated"``, see
    ``repro_torch.parallel.sharding``) marks split, its block of dim 0;
    the rest come back whole. A split leaf's dim 0 must be a multiple of
    the rank count, so restore on more or fewer ranks needs no
    conversion step."""
    from repro_torch._tree import tree_map
    from repro_torch.parallel.sharding import rank_block
    return tree_map(lambda leaf, marker: rank_block(mesh, leaf, marker),
                    restore_checkpoint(path, template, overlay=overlay),
                    splits)
