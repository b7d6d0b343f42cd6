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

**The LM serving programs** (``make_sharded_prefill``,
``make_sharded_decode_step``): the counterparts of JAX's jitted
``lm_prefill`` / ``lm_decode_step`` under ``lm_cache_specs``. Each rank
takes its batch rows, gathers the parameters at use and holds its block
of the KV cache: a run of 8192 slots or more split on its sequence over
"model" (over every axis when the batch is not split), a window's cache
whole. Prefill writes the slots of the rank's block; decode writes the
step's K / V on the rank that holds its slot and attends over its block,
merged over the ranks that hold the others (``decode_attention``). Both
return the logits' vocabulary block. On a mesh of one rank they run the
one-process operations in their order.

**The recommenders' serve programs** (``make_serve_step``,
``twotower_retrieval_step``): each rank runs the serve function on its
block of the batch with the tables gathered at use; ``retrieval_cand``
scores the rank's block of the candidates, and the two-tower retrieval
merges the ranks' shortlists in ``lax.top_k``'s order, as the sharded
search does (``search.serve``'s merge).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch._tree import keyed_leaves, tree_map, tree_unflatten
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import (_NEG_INF, LMConfig, _layer_self,
                                            _layers, _mlp, _qkv, _window,
                                            layer_runs, lm_train_forward)
from repro_torch.optim.adamw import AdamWConfig, sharded_adamw_update

from . import context as ctx
from .sharding import P, dp_axes, replicate_like

__all__ = ["lm_batch_specs", "moe_blocks", "gather_at_use",
           "sharded_value_and_grad", "sharded_loss_and_grad",
           "make_sharded_train_step", "make_sharded_step",
           "gin_full_rank_loss", "make_serve_step",
           "twotower_retrieval_step", "make_sharded_prefill",
           "make_sharded_decode_step", "decode_attention"]


def lm_batch_specs(mesh) -> Dict[str, P]:
    """The batch's specs: rows split over the data axes."""
    dp = dp_axes(mesh)
    return {"tokens": P(dp or None, None), "labels": P(dp or None, None)}


def _use_specs(param_specs: Any, moe_blocks: bool) -> Any:
    """``param_specs`` with each MoE sub-tree of an LM's runs marked
    whole when ``moe_blocks``: those blocks go to ``moe.moe_block`` as
    they are."""
    if (not moe_blocks or not isinstance(param_specs, dict)
            or "runs" not in param_specs):
        return param_specs
    runs = [{k: (replicate_like(v) if k == "moe" else v)
             for k, v in run.items()} for run in param_specs["runs"]]
    return {**param_specs, "runs": runs}


def moe_blocks(cfg: LMConfig) -> bool:
    """Whether ``cfg``'s MoE layers take the rank's blocks of their
    parameters, which ``moe.moe_block`` under a mesh gathers itself where
    it needs them: under ``impl="ep"`` (the experts stay local and the
    tokens travel) and ``"dispatch"`` (the whole batch's capacity). The
    dense combine runs over every expert it is given, so for it the MoE
    leaves are gathered at use."""
    return cfg.moe is not None and cfg.moe.impl in ("ep", "dispatch")


def gather_at_use(mesh, params: Any, param_specs: Any,
                  keep_moe_blocks: bool = False) -> Any:
    """The parameters a rank's forward uses: every leaf gathered over the
    axes its spec splits it on (``context.gather_replicated``), an LM's
    MoE leaves kept as this rank's blocks if ``keep_moe_blocks``
    (``moe_blocks(cfg)``)."""
    def gather(block, spec):
        for dim, entry in enumerate(spec):
            if entry is not None:
                block = ctx.gather_replicated(mesh, block, entry, dim)
        return block

    return tree_map(gather, params, _use_specs(param_specs, keep_moe_blocks))


def sharded_loss_and_grad(loss_fn: Callable[[Any, Any], torch.Tensor],
                          mesh, param_specs: Any, params: Any,
                          batch: Any, keep_moe_blocks: bool = False
                          ) -> Tuple[torch.Tensor, Any]:
    """(the global loss, this rank's gradient blocks as the mean over the
    data axes) of ``loss_fn(parameters gathered at use, batch)`` on this
    rank's ``batch`` (``gather_at_use``'s ``keep_moe_blocks``). Marks the
    parameter blocks as requiring grad."""
    keyed = keyed_leaves(params)
    leaves = [leaf for _, leaf in keyed]
    for p in leaves:
        p.requires_grad_(True)
    with ctx.mesh_context(mesh):
        local = loss_fn(gather_at_use(mesh, params, param_specs,
                                      keep_moe_blocks), batch)
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
        batch, moe_blocks(cfg))


def make_sharded_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                      adam: AdamWConfig, mesh, param_specs: Any,
                      opt_specs: Any, keep_moe_blocks: bool = False):
    """step(params, opt_state, batch) -> (loss, params, opt_state) on this
    rank's blocks: ``sharded_loss_and_grad`` of ``loss_fn``, then
    ``sharded_adamw_update``; the parameters and moments are updated in
    place."""

    def step(params, opt_state, batch):
        loss, grads = sharded_loss_and_grad(loss_fn, mesh, param_specs,
                                            params, batch, keep_moe_blocks)
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
                             mesh, param_specs, opt_specs, moe_blocks(cfg))


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


# ----------------------------------------------------------- LM serving

def _seq_axes(mesh, cache_spec_run) -> Tuple[str, ...]:
    """The axes (of size > 1) a run's cache spec splits the sequence on."""
    entry = cache_spec_run["k"][2]
    if entry is None:
        return ()
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(a for a in axes if mesh.shape[a] > 1)


def _block_start(mesh, axes: Tuple[str, ...], s_loc: int) -> int:
    """The first slot of this rank's block of a cache split over
    ``axes``."""
    return mesh.axis_index(axes) * s_loc if axes else 0


def _serving_config(cfg: LMConfig, cache_specs) -> Tuple[LMConfig, bool]:
    """(``cfg`` as a serving rank runs it, whether its MoE layers run under
    the mesh). Rows the data axes split (the cache specs' batch entry) run
    under the mesh with the MoE blocks (``moe_blocks``). Rows every rank
    holds whole run ``ep`` and ``dispatch`` as JAX's jit does then (its
    ``_ep_applicable`` needs the batch split over the data axes):
    ``dispatch`` over the rank's rows, which are the whole batch, with
    every expert gathered at use."""
    if cfg.moe is None or cache_specs[0]["k"][1] is not None:
        return cfg, True
    if cfg.moe.impl == "ep":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="dispatch"))
    return cfg, False


def _logits_block(cfg: LMConfig, mesh, params, h: torch.Tensor
                  ) -> torch.Tensor:
    """This rank's vocabulary block of the serving logits (``out_specs``'
    ``P(b_ax, "model")``): ``h`` times the rank's block of the head (the
    tied embedding's rows, or the untied head's columns, both split over
    "model"), the padded tail masked in global column terms."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ head
    n = logits.shape[-1]
    start = mesh.axis_index("model") * n if "model" in mesh.axis_names \
        else 0
    if start + n > cfg.vocab:                  # the padded vocab tail
        logits[..., max(cfg.vocab - start, 0):] = _NEG_INF
    return logits


def _prefill_writes(s: int, s_run: int, start: int, s_loc: int,
                    dev) -> Tuple[torch.Tensor, ...]:
    """``lm_prefill``'s ring writes for a prompt of ``s`` tokens into a run
    of ``s_run`` slots: (positions, slots) of the whole cache (``pos`` is
    whole on every rank), then (positions, local slots) of those that fall
    in this rank's block [start, start + s_loc). The owned ones are found
    on the host as runs of consecutive positions (the shapes are static,
    and a fake trace makes each run with ``arange``)."""
    n_write = min(s, s_run)
    src = torch.arange(s - n_write, s, device=dev)
    dst = src % s_run
    if start == 0 and s_loc == s_run:
        return src, dst, src, dst
    runs = []
    for p in range(s - n_write, s):
        if start <= p % s_run < start + s_loc:
            if runs and runs[-1][1] == p:
                runs[-1][1] = p + 1
            else:
                runs.append([p, p + 1])
    src_m = torch.cat([torch.arange(a, b, device=dev) for a, b in runs]) \
        if runs else torch.arange(0, device=dev)
    return src, dst, src_m, src_m % s_run - start


def make_sharded_prefill(cfg: LMConfig, mesh, param_specs: Any,
                         cache_specs: Any):
    """program(params, tokens, cache) -> (logits block, cache blocks): the
    rank program of ``lm_prefill`` over ``mesh`` (JAX's jitted
    ``lm_prefill`` under ``in_shardings = (param_specs, P(b_ax, None),
    cache_specs)``).

    Each rank takes its batch rows with the whole prompt, gathers the
    parameters at use (the MoE layers keep their blocks under ``ep``) and
    runs the layers as ``lm_prefill`` does (``cfg.attn_impl="flash"``: K5).
    It writes only the slots of each run's cache block it holds (the ring
    buffers of local runs as ``lm_prefill`` writes them) and the whole
    ``pos``, and returns the last position's logits over its vocabulary
    block. On a mesh of one rank it runs ``lm_prefill``'s operations in
    their order. The cache blocks are written in place."""
    cfg, under_mesh = _serving_config(cfg, cache_specs)
    keep = under_mesh and moe_blocks(cfg)
    seq = [_seq_axes(mesh, run) for run in cache_specs]

    @torch.inference_mode()
    def program(params, tokens, cache):
        full = gather_at_use(mesh, params, param_specs, keep)
        b, s = tokens.shape
        dev = tokens.device
        h = full["embed"][tokens].to(cfg.dtype)
        q_pos = torch.arange(s, device=dev)
        with (ctx.mesh_context(mesh) if under_mesh
              else contextlib.nullcontext()):
            for ri, (kind, _) in enumerate(layer_runs(cfg)):
                rc = cache[ri]
                s_loc = rc["k"].shape[2]
                src, dst, src_m, dst_m = _prefill_writes(
                    s, rc["pos"].shape[0],
                    _block_start(mesh, seq[ri], s_loc), s_loc, dev)
                for i, lp in enumerate(_layers(full["runs"][ri])):
                    h, k, v, _ = _layer_self(cfg, _window(cfg, kind), h, lp,
                                             q_pos)
                    rc["k"][i][:, dst_m] = k[:, src_m].to(rc["k"].dtype)
                    rc["v"][i][:, dst_m] = v[:, src_m].to(rc["v"].dtype)
                rc["pos"][dst] = src.to(torch.int32)
        h = rms_norm(h, full["final_norm"])
        return _logits_block(cfg, mesh, params, h[:, -1:, :])[:, 0], cache

    return program


def decode_attention(mesh, axes: Tuple[str, ...], q: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                     kv_pos: torch.Tensor, window: Optional[int]
                     ) -> torch.Tensor:
    """A rank's decode attention over its block of the cache: the
    one-chunk softmax of ``layers.chunked_attention`` (decode attends with
    the whole cache as one KV chunk) partitioned over the ranks along
    ``axes`` that hold the other blocks, as GSPMD partitions JAX's.

    q: (B, 1, H, dh); k, v: this rank's (B, S_loc, KV, dh) block;
    kv_pos: its slots' positions. The scores over the rank's slots, the
    maximum M over every rank (``all_reduce_max``), p = exp(s - M), and
    one ``all_reduce_sum`` of [sum p, p v] packed together; the output is
    their quotient. Only the global M is subtracted: a block with no
    visible slot (s = -1e30 everywhere) has a local maximum of -1e30, and
    exp(s - local max) would weigh each of its slots 1, not 0. With no
    axis this runs ``_attn_one_q_chunk``'s operations for one chunk, bit
    for bit. Returns (B, 1, H, dh) in q's dtype."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.reshape(b, sq, kvh, g, dh).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bckd->bqkgc", qf, kf) * (1.0 / math.sqrt(dh))
    ok = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] >= 0)
    if window is not None:
        ok &= (q_pos[:, None] - kv_pos[None, :]) < window
    s = s.masked_fill(~ok[None, :, None, None, :], _NEG_INF)
    m = torch.maximum(torch.full((b, sq, kvh, g), _NEG_INF,
                                 dtype=torch.float32, device=q.device),
                      s.amax(dim=-1))
    if axes:
        m = ctx.all_reduce_max(mesh, m, axes)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bqkgc,bckd->bqkgd", p, vf)
    if axes:
        both = ctx.all_reduce_sum(mesh, torch.cat([l[..., None], acc],
                                                  dim=-1), axes)
        l, acc = both[..., 0], both[..., 1:]
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def make_sharded_decode_step(cfg: LMConfig, mesh, param_specs: Any,
                             cache_specs: Any):
    """program(params, token, cur, cache) -> (logits block, cache blocks):
    the rank program of ``lm_decode_step`` over ``mesh`` (JAX's jitted
    decode step under ``in_shardings = (param_specs, P(b_ax), P(),
    cache_specs)``).

    Each rank takes its batch rows' tokens, gathers the parameters at use
    (the MoE leaves too: decode runs the dense combine, which reads every
    expert), sets ``pos`` (whole on every rank) at ``cur``'s slot, and per
    layer writes this step's K / V only where its block holds that slot,
    then attends over its block (``decode_attention``, merged over the
    axes the cache's spec splits the sequence on; a run whose cache is
    whole attends locally). ``cur`` is a 0-d integer tensor (the cell's
    ``P()`` argument), never read on the host: the dry-run traces it as a
    fake tensor, and a position past a full cache fails in the index
    write. On a mesh of one rank it runs ``lm_decode_step``'s operations,
    bit for bit. The cache blocks are written in place."""
    cfg, under_mesh = _serving_config(cfg, cache_specs)
    keep = under_mesh and moe_blocks(cfg)
    seq = [_seq_axes(mesh, run) for run in cache_specs]

    @torch.inference_mode()
    def program(params, token, cur, cache):
        full = gather_at_use(mesh, params, param_specs, keep)
        q_pos = cur.reshape(1).to(device=token.device, dtype=torch.int32)
        h = full["embed"][token][:, None, :].to(cfg.dtype)
        with (ctx.mesh_context(mesh) if under_mesh
              else contextlib.nullcontext()):
            for ri, (kind, _) in enumerate(layer_runs(cfg)):
                rc = cache[ri]
                s_run, s_loc = rc["pos"].shape[0], rc["k"].shape[2]
                window = _window(cfg, kind)
                ring = kind == "local" and window and s_run == window
                slot = (q_pos % s_run if ring else q_pos).long()
                rc["pos"].index_put_((slot,), q_pos)
                start = _block_start(mesh, seq[ri], s_loc)
                loc = slot - start
                owned = ((loc >= 0) & (loc < s_loc)).view(1, 1, 1, 1)
                idx = loc.clamp(0, s_loc - 1)
                kv_pos = rc["pos"][start:start + s_loc]
                for i, lp in enumerate(_layers(full["runs"][ri])):
                    ck, cv = rc["k"][i], rc["v"][i]
                    q, k, v = _qkv(cfg, rms_norm(h, lp["ln1"]), lp, q_pos,
                                   window)
                    ck[:, idx] = torch.where(owned, k.to(ck.dtype),
                                             ck[:, idx])
                    cv[:, idx] = torch.where(owned, v.to(cv.dtype),
                                             cv[:, idx])
                    attn = decode_attention(mesh, seq[ri], q,
                                            ck.to(q.dtype), cv.to(q.dtype),
                                            q_pos, kv_pos, window)
                    h = h + attn.reshape(h.shape[0], 1, -1) @ lp["wo"]
                    h = _mlp(cfg, h, lp)[0]
        h = rms_norm(h, full["final_norm"])
        return _logits_block(cfg, mesh, params, h)[:, 0], cache

    return program
