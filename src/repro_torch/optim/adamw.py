"""AdamW with a warmup + cosine schedule and global-norm clipping (port of
``repro.optim.adamw``) over the port's parameter trees (nested dicts and
lists of tensors). Moments are f32 whatever the parameter dtype; the
update is computed in f32 and cast back to the parameter's dtype.

Unlike JAX, whose arrays are immutable, ``adamw_update`` writes the new
parameters and moments into the tensors it is given (it still returns the
same structures): a full-width model then holds one copy of its
parameters and moments, not two. The arithmetic follows the JAX code
operation for operation, in f32.

Over a mesh of ranks (``parallel.step``), each rank holds its blocks of
the parameters under their specs and its blocks of the moments under the
ZeRO-1 specs (``parallel.sharding.zero_opt_specs``: a moment may also be
split over the data axes). ``sharded_global_norm`` sums each leaf's
block sum of squares over the axes its spec splits it on (a replicated
leaf counted once), and ``sharded_adamw_update`` updates each rank's
data block of its parameter block with its moments, then all-gathers
the updated blocks over the data axes: JAX's ZeRO-1 traffic. At a mesh
of one rank both run ``global_norm`` / ``adamw_update``'s operations in
their order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch._tree import keyed_leaves, tree_leaves, tree_map, \
    tree_unflatten

__all__ = ["AdamWConfig", "init_opt_state", "global_norm", "adamw_update",
           "value_and_grad", "make_train_step", "init_zero_opt_state",
           "sharded_global_norm", "sharded_adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), as f32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp_max(warm, 1.0) * torch.where(
        step < cfg.warmup_steps, 1.0, cos)


def init_opt_state(params: Any) -> Dict[str, Any]:
    """``{"step": 0 (int32), "m": f32 zeros, "v": f32 zeros}`` beside the
    parameters, on their device."""
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (leaf sums added
    in JAX's leaf order)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _prologue(opt_state, cfg: AdamWConfig):
    """(step + 1, its learning rate, the two bias corrections)."""
    step = opt_state["step"] + 1
    b1, b2 = cfg.beta1, cfg.beta2
    return (step, _schedule(cfg, step), 1 - b1 ** step.to(torch.float32),
            1 - b2 ** step.to(torch.float32))


def _clip_scale(gn: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    return torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-9), 1.0)


def _update_leaf(p, g, m, v, lr, bc1, bc2, cfg: AdamWConfig):
    """One leaf's AdamW step, in place in ``p``, ``m`` and ``v``."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float()
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(g * (1 - b2) * g)
    p32 = p.float()
    u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    u = u + cfg.weight_decay * p32
    p.copy_((p32 - lr * u).to(p.dtype))
    return p


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any,
                 cfg: AdamWConfig) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step: returns (params, opt_state), both updated in
    place."""
    step, lr, bc1, bc2 = _prologue(opt_state, cfg)
    if cfg.clip_norm is not None:
        scale = _clip_scale(global_norm(grads), cfg)
        # f32, as JAX promotes a bf16 gradient times an f32 scale
        grads = tree_map(lambda g: g.float() * scale, grads)
    tree_map(lambda p, g, m, v: _update_leaf(p, g, m, v, lr, bc1, bc2, cfg),
             params, grads, opt_state["m"], opt_state["v"])
    return params, {"step": step, "m": opt_state["m"], "v": opt_state["v"]}


def _split_axes(spec, ndim: int) -> list:
    """Each dim's axes under ``spec`` (a ``parallel.sharding.P``), () for
    a whole dim."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return [() if e is None else (e,) if isinstance(e, str) else tuple(e)
            for e in entries]


def _zero_dim(pspec, mspec, ndim: int):
    """(dim, axes) of the dim the moment spec splits over the data axes
    beyond its parameter's spec, or None (the moment is split as its
    parameter is)."""
    for dim, (pa, ma) in enumerate(zip(_split_axes(pspec, ndim),
                                       _split_axes(mspec, ndim))):
        if pa != ma:
            return dim, ma
    return None


def init_zero_opt_state(mesh, params: Any, param_specs: Any,
                        opt_specs: Any) -> Dict[str, Any]:
    """This rank's blocks of ``init_opt_state`` of the full parameters
    under ``opt_specs``: f32 zeros, a moment's ZeRO dim cut to this
    rank's data block of the parameter block ``params`` holds."""
    def zeros(p, pspec, mspec):
        shape = list(p.shape)
        z = _zero_dim(pspec, mspec, p.dim())
        if z is not None:
            shape[z[0]] //= mesh.axis_size(z[1])
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params, param_specs, opt_specs["m"]),
            "v": tree_map(zeros, params, param_specs, opt_specs["v"])}


def sharded_global_norm(mesh, grads: Any, param_specs: Any) -> torch.Tensor:
    """The global norm of the full gradient from this rank's blocks: each
    leaf's block sum of squares (f32), summed over the axes its spec
    splits it on (one all-reduce per set of axes), then the leaves' sums
    added in JAX's leaf order; a leaf whole on every rank is counted
    once."""
    from repro_torch.parallel.context import all_reduce_sum
    leaves = tree_leaves(grads)
    specs = tree_leaves(param_specs)
    sums = [torch.sum(torch.square(x.float())) for x in leaves]
    by_axes: Dict[tuple, list] = {}
    for i, (x, spec) in enumerate(zip(leaves, specs)):
        axes = tuple(a for d in _split_axes(spec, x.dim()) for a in d
                     if mesh.shape[a] > 1)
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        total = all_reduce_sum(mesh, torch.stack([sums[i] for i in idx]),
                               axes)
        for i, s in zip(idx, total.unbind(0)):
            sums[i] = s
    return torch.sqrt(sum(sums))


@torch.no_grad()
def sharded_adamw_update(mesh, grads: Any, opt_state: Dict[str, Any],
                         params: Any, cfg: AdamWConfig, param_specs: Any,
                         opt_specs: Any) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step on this rank's blocks (``params`` and ``grads``
    under ``param_specs``, the moments under ``opt_specs``; the gradients
    already the mean over the data axes): the clip by
    ``sharded_global_norm``, then each leaf's update on this rank's data
    block of its parameter block, all-gathered over the data axes into
    the parameter block. Updated in place, returned as ``adamw_update``
    returns them."""
    from repro_torch.parallel.context import all_gather
    step, lr, bc1, bc2 = _prologue(opt_state, cfg)
    if cfg.clip_norm is not None:
        scale = _clip_scale(sharded_global_norm(mesh, grads, param_specs),
                            cfg)
        grads = tree_map(lambda g: g.float() * scale, grads)

    def upd(p, g, m, v, pspec, mspec):
        z = _zero_dim(pspec, mspec, p.dim())
        if z is None:
            return _update_leaf(p, g, m, v, lr, bc1, bc2, cfg)
        dim, axes = z
        per = p.shape[dim] // mesh.axis_size(axes)
        at = mesh.axis_index(axes) * per
        mine = p.narrow(dim, at, per)
        _update_leaf(mine, g.narrow(dim, at, per), m, v, lr, bc1, bc2, cfg)
        p.copy_(all_gather(mesh, mine, dim, axes))
        return p

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"], param_specs,
             opt_specs["m"])
    return params, {"step": step, "m": opt_state["m"], "v": opt_state["v"]}


def value_and_grad(loss_fn: Callable[[Any, Any], torch.Tensor], params: Any,
                   batch: Any) -> Tuple[torch.Tensor, Any]:
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient in every
    parameter leaf, by ``torch.autograd.grad`` (a leaf the loss does not
    use gets zeros, as in JAX). Marks the leaves as requiring grad."""
    leaves = [leaf for _, leaf in keyed_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                    cfg: AdamWConfig):
    """loss_fn(params, batch) -> scalar. Returns
    step(params, opt_state, batch) -> (loss, params, opt_state)."""

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = adamw_update(grads, opt_state, params, cfg)
        return loss, params, opt_state

    return step
