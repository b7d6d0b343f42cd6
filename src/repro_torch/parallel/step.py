"""The LM train step over a mesh of ranks (port-only: the counterpart of
``jax.jit(make_train_step(...), in_shardings=tree_named(mesh, (param
specs, ZeRO-1 opt specs, batch specs)), out_shardings=...)``, which the
JAX package's dry-run compiles).

Each rank holds its blocks of the parameters under
``sharding.lm_param_specs``, its blocks of the AdamW moments under
``sharding.zero_opt_specs`` (``optim.adamw.init_zero_opt_state``) and its
data block of the batch (rows split over the data axes: ``P(dp, None)``).
A step:

1. gathers every parameter outside the MoE layers at use
   (``context.gather_replicated``: every rank of the model axis then
   computes the same full activations, and the backward keeps the rank's
   block of the gradient); the MoE layers take their own blocks
   (``models.moe``: under ``impl="ep"`` the experts stay local and the
   tokens travel);
2. runs ``transformer.lm_train_forward`` on the rank's rows under the
   mesh (``context.mesh_context``) and differentiates it;
3. takes the mean of the gradient blocks over the data axes (f32, one
   all-reduce);
4. clips by the global norm over blocks and applies the ZeRO-1 update
   (``optim.adamw.sharded_adamw_update``).

The loss it returns is the global one: the mean over the data ranks of
their rows' mean, plus the aux weight times the layers' aux losses (each
already the mean over every rank). On a mesh of one rank nothing is
gathered, exchanged or reduced, and the step runs ``make_train_step``'s
operations in their order.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch._tree import keyed_leaves, tree_map, tree_unflatten
from repro_torch.models.transformer import LMConfig, lm_train_forward
from repro_torch.optim.adamw import AdamWConfig, sharded_adamw_update

from . import context as ctx
from .sharding import P, dp_axes, replicate_like

__all__ = ["lm_batch_specs", "gather_at_use", "sharded_value_and_grad",
           "make_sharded_train_step"]


def lm_batch_specs(mesh) -> Dict[str, P]:
    """The batch's specs: rows split over the data axes."""
    dp = dp_axes(mesh)
    return {"tokens": P(dp or None, None), "labels": P(dp or None, None)}


def _use_specs(param_specs: Dict[str, Any]) -> Dict[str, Any]:
    """``param_specs`` with each MoE sub-tree marked whole: those blocks
    go to ``moe.moe_block`` as they are."""
    runs = [{k: (replicate_like(v) if k == "moe" else v)
             for k, v in run.items()} for run in param_specs["runs"]]
    return {**param_specs, "runs": runs}


def gather_at_use(mesh, params: Any, param_specs: Any) -> Any:
    """The parameters a rank's forward uses: every leaf outside the MoE
    layers gathered over the axes its spec splits it on
    (``context.gather_replicated``), the MoE leaves as this rank's
    blocks."""
    def gather(block, spec):
        for dim, entry in enumerate(spec):
            if entry is not None:
                block = ctx.gather_replicated(mesh, block, entry, dim)
        return block

    return tree_map(gather, params, _use_specs(param_specs))


def sharded_value_and_grad(cfg: LMConfig, mesh, param_specs: Any,
                           params: Any, batch: Dict[str, torch.Tensor]
                           ) -> Tuple[torch.Tensor, Any]:
    """(the global loss, this rank's gradient blocks as the mean over the
    data axes) of ``lm_train_forward`` on this rank's ``batch`` rows.
    Marks the parameter blocks as requiring grad."""
    keyed = keyed_leaves(params)
    leaves = [leaf for _, leaf in keyed]
    for p in leaves:
        p.requires_grad_(True)
    with ctx.mesh_context(mesh):
        local = lm_train_forward(gather_at_use(mesh, params, param_specs),
                                 cfg, batch)
        grads = list(torch.autograd.grad(local, leaves, allow_unused=True,
                                         materialize_grads=True))
    loss = local.detach()
    dp = tuple(a for a in dp_axes(mesh) if mesh.shape[a] > 1)
    if dp:
        n = mesh.axis_size(dp)
        loss = ctx.all_reduce_sum(mesh, loss, dp) / n
        flat = ctx.all_reduce_sum(mesh, torch.cat(
            [g.float().reshape(-1) for g in grads]), dp) / n
        grads = [part.view(g.shape) for part, g in zip(
            flat.split([g.numel() for g in grads]), grads)]
    return loss, tree_unflatten(params, grads)


def make_sharded_train_step(cfg: LMConfig, adam: AdamWConfig, mesh,
                            param_specs: Any, opt_specs: Any):
    """step(params, opt_state, batch) -> (loss, params, opt_state) on this
    rank's blocks (the module docstring); the parameters and moments are
    updated in place."""

    def step(params, opt_state, batch):
        loss, grads = sharded_value_and_grad(cfg, mesh, param_specs, params,
                                             batch)
        params, opt_state = sharded_adamw_update(
            mesh, grads, opt_state, params, adam, param_specs, opt_specs)
        return loss, params, opt_state

    return step
