"""AdamW with a warmup + cosine schedule and global-norm clipping (port of
``repro.optim.adamw``) over the port's parameter trees (nested dicts and
lists of tensors). Moments are f32 whatever the parameter dtype; the
update is computed in f32 and cast back to the parameter's dtype.

Unlike JAX, whose arrays are immutable, ``adamw_update`` writes the new
parameters and moments into the tensors it is given (it still returns the
same structures): a full-width model then holds one copy of its
parameters and moments, not two. The arithmetic follows the JAX code
operation for operation, in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch._tree import keyed_leaves, tree_leaves, tree_map, \
    tree_unflatten

__all__ = ["AdamWConfig", "init_opt_state", "global_norm", "adamw_update",
           "value_and_grad", "make_train_step"]


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


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any,
                 cfg: AdamWConfig) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step: returns (params, opt_state), both updated in
    place."""
    step = opt_state["step"] + 1
    lr = _schedule(cfg, step)
    if cfg.clip_norm is not None:
        gn = global_norm(grads)
        scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-9),
                                1.0)
        # f32, as JAX promotes a bf16 gradient times an f32 scale
        grads = tree_map(lambda g: g.float() * scale, grads)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        p32 = p.float()
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p32
        p.copy_((p32 - lr * u).to(p.dtype))
        return p

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
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
