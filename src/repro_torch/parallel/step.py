"""The rank programs of the model side over a mesh of ranks (port-only:
each is the counterpart of a ``jax.jit(step, in_shardings=tree_named(mesh,
arg specs), out_shardings=...)`` that the JAX package's dry-run compiles;
``configs.common.ArchSpec.step_fn`` returns them, and ``launch.dryrun``
traces them).

**The LM train step** (``make_sharded_train_step``). Each rank holds its
blocks of the parameters under ``sharding.lm_param_specs``, its blocks of
the AdamW moments under ``sharding.zero_opt_specs``
(``optim.adamw.init_zero_opt_state``) and its data block of the batch
(rows split over the data axes: ``P(dp, None)``). A step:

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

**Any family's train step** (``make_sharded_step``): the same four steps
for any loss, every parameter gathered at use over its spec's axes; with
moment specs equal to the parameters' (``sharding.opt_specs``, the
recommenders' and GIN's) the update is each rank's own. GIN's full-graph
regime splits the edges over every axis (JAX's ``P(all axes)``):
``gin_full_rank_loss`` aggregates the rank's block of the edges and adds
the ranks' partial sums (``context.use_partial`` / ``sum_partial``), as
XLA partitions JAX's ``segment_sum``; the card route stays
``kernels/graph_agg``.

**The recommenders' serve programs** (``make_serve_step``,
``twotower_retrieval_step``): each rank runs the serve function on its
block of the batch with the tables gathered at use; ``retrieval_cand``
scores the rank's block of the candidates, and the two-tower retrieval
merges the ranks' shortlists in ``lax.top_k``'s order, as the sharded
search does (``search.serve``'s merge).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch._tree import keyed_leaves, tree_map, tree_unflatten
from repro_torch.models.transformer import LMConfig, lm_train_forward
from repro_torch.optim.adamw import AdamWConfig, sharded_adamw_update

from . import context as ctx
from .sharding import P, dp_axes, replicate_like

__all__ = ["lm_batch_specs", "gather_at_use", "sharded_value_and_grad",
           "sharded_loss_and_grad", "make_sharded_train_step",
           "make_sharded_step", "gin_full_rank_loss", "make_serve_step",
           "twotower_retrieval_step"]


def lm_batch_specs(mesh) -> Dict[str, P]:
    """The batch's specs: rows split over the data axes."""
    dp = dp_axes(mesh)
    return {"tokens": P(dp or None, None), "labels": P(dp or None, None)}


def _use_specs(param_specs: Any) -> Any:
    """``param_specs`` with each MoE sub-tree of an LM's runs marked
    whole: those blocks go to ``moe.moe_block`` as they are."""
    if not isinstance(param_specs, dict) or "runs" not in param_specs:
        return param_specs
    runs = [{k: (replicate_like(v) if k == "moe" else v)
             for k, v in run.items()} for run in param_specs["runs"]]
    return {**param_specs, "runs": runs}


def gather_at_use(mesh, params: Any, param_specs: Any) -> Any:
    """The parameters a rank's forward uses: every leaf gathered over the
    axes its spec splits it on (``context.gather_replicated``), an LM's
    MoE leaves kept as this rank's blocks."""
    def gather(block, spec):
        for dim, entry in enumerate(spec):
            if entry is not None:
                block = ctx.gather_replicated(mesh, block, entry, dim)
        return block

    return tree_map(gather, params, _use_specs(param_specs))


def sharded_loss_and_grad(loss_fn: Callable[[Any, Any], torch.Tensor],
                          mesh, param_specs: Any, params: Any,
                          batch: Any) -> Tuple[torch.Tensor, Any]:
    """(the global loss, this rank's gradient blocks as the mean over the
    data axes) of ``loss_fn(parameters gathered at use, batch)`` on this
    rank's ``batch``. Marks the parameter blocks as requiring grad."""
    keyed = keyed_leaves(params)
    leaves = [leaf for _, leaf in keyed]
    for p in leaves:
        p.requires_grad_(True)
    with ctx.mesh_context(mesh):
        local = loss_fn(gather_at_use(mesh, params, param_specs), batch)
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


def sharded_value_and_grad(cfg: LMConfig, mesh, param_specs: Any,
                           params: Any, batch: Dict[str, torch.Tensor]
                           ) -> Tuple[torch.Tensor, Any]:
    """``sharded_loss_and_grad`` of ``lm_train_forward`` on this rank's
    ``batch`` rows."""
    return sharded_loss_and_grad(
        lambda p, b: lm_train_forward(p, cfg, b), mesh, param_specs, params,
        batch)


def make_sharded_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                      adam: AdamWConfig, mesh, param_specs: Any,
                      opt_specs: Any):
    """step(params, opt_state, batch) -> (loss, params, opt_state) on this
    rank's blocks: ``sharded_loss_and_grad`` of ``loss_fn``, then
    ``sharded_adamw_update``; the parameters and moments are updated in
    place."""

    def step(params, opt_state, batch):
        loss, grads = sharded_loss_and_grad(loss_fn, mesh, param_specs,
                                            params, batch)
        params, opt_state = sharded_adamw_update(
            mesh, grads, opt_state, params, adam, param_specs, opt_specs)
        return loss, params, opt_state

    return step


def make_sharded_train_step(cfg: LMConfig, adam: AdamWConfig, mesh,
                            param_specs: Any, opt_specs: Any):
    """step(params, opt_state, batch) -> (loss, params, opt_state) on this
    rank's blocks (the module docstring); the parameters and moments are
    updated in place."""
    return make_sharded_step(lambda p, b: lm_train_forward(p, cfg, b), adam,
                             mesh, param_specs, opt_specs)


def gin_full_rank_loss(cfg, mesh):
    """GIN's full-graph loss on a rank that holds every node and its block
    of the edges (split over every axis of ``mesh``): each layer's
    neighbour sum is the rank's partial aggregate over its edges
    (``kernels.graph_agg.gin_aggregate``), added over the ranks
    (``context.sum_partial``); the node features enter it through
    ``context.use_partial``, whose backward adds the ranks' partial
    gradients. Every rank then computes the same loss."""
    from repro_torch.kernels.graph_agg import gin_aggregate
    from repro_torch.models import gnn

    def aggregate(h, csr):
        return ctx.sum_partial(mesh, gin_aggregate(
            ctx.use_partial(mesh, h), csr))

    def loss(params, batch):
        return gnn.gin_full_loss(params, cfg, batch, aggregate=aggregate)

    return loss


def make_serve_step(serve_fn: Callable[[Any, Any], Any], mesh,
                    param_specs: Any):
    """program(params, batch) -> ``serve_fn``'s output on this rank's
    block of the batch, the tables gathered at use, under the mesh, with
    no gradient."""

    @torch.no_grad()
    def program(params, batch):
        with ctx.mesh_context(mesh):
            return serve_fn(gather_at_use(mesh, params, param_specs), batch)

    return program


def _merge_ranked(mesh, rows: torch.Tensor, by: int, k: int
                  ) -> torch.Tensor:
    """Every rank's ``rows`` (f64 (n_fields, n)) gathered in rank order,
    then the k columns with the largest field ``by`` (ties to the earlier
    column: ``lax.top_k``'s order, as every rank's list is in it and lists
    come in rank order)."""
    from repro_torch.models.moe import top_k
    both = ctx.all_gather(mesh, rows, dim=1)
    _, sel = top_k(both[by].float(), k)
    return both[:, sel]


def twotower_retrieval_step(cfg, mesh, param_specs: Any, k: int,
                            mode: str = "mpad", rerank: int = 256):
    """The two-tower ``retrieval_cand`` rank program: this rank scores its
    block of the candidates (``cand_emb`` and the reduced cache split over
    every axis), keeps its top-k (``full``) or its top-max(k, rerank)
    shortlist by the reduced score with each member's exact score
    (``mpad``, ``int8``), then the ranks' lists are all-gathered (one
    collective: f64 holds every f32 score and id exactly) and merged:
    the global shortlist by the reduced score, then the top-k by the exact
    score. Returns (scores (k,), candidate ids (k,)), the same on every
    rank."""
    from repro_torch.models import recsys as rs

    def serve(p, batch):
        n_loc = batch["cand_emb"].shape[0]
        off = mesh.axis_index() * n_loc
        u = rs.twotower_user(p, cfg, batch["user_ids"], batch["hist_ids"])
        if mode == "full":
            s, ids = rs.top_k((u @ batch["cand_emb"].T)[0], k)
            got = _merge_ranked(mesh, torch.stack(
                [s.double(), (ids + off).double()]), 0, k)
            return got[0].float(), got[1].long()
        mat, mean = batch["red_matrix"], batch["red_mean"]
        scores_r = rs.reduced_scores(u, batch, (mat, mean), mode == "int8")
        _, pre = rs.top_k(scores_r, min(max(k, rerank), n_loc))
        exact = (u @ batch["cand_emb"][pre].T)[0]
        short = _merge_ranked(mesh, torch.stack(
            [scores_r[pre].double(), exact.double(), (pre + off).double()]),
            0, max(k, rerank))
        s, loc = rs.top_k(short[1].float(), k)
        return s, short[2, loc].long()

    return make_serve_step(serve, mesh, param_specs)
