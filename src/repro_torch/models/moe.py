"""Mixture-of-Experts FFN block (port of ``repro.models.moe``; granite-moe,
olmoe).

Two implementations with identical no-drop semantics:

* ``dense``    — every expert processes every token, combined by the gate
                 matrix. O(E) overcompute; the mathematical reference, used
                 for decode shapes (where the token count is tiny) and as
                 the oracle in tests.
* ``dispatch`` — sort-by-expert + capacity buffers: the (token, expert)
                 assignments are sorted by expert id (a stable sort), each
                 expert receives a fixed-capacity (C) slice, the per-expert
                 FFNs run as batched matmuls over the (E, C, D) buffer, and
                 the results come back weighted by the renormalized router
                 gates. Capacity overflow drops the assignment (the
                 residual passes through), as in Switch/GShard.
* ``ep``       — expert parallelism over the active mesh's "model" axis
                 (JAX's ``_moe_ep_shardmap``). Each model rank routes its
                 slice of the data rank's tokens with the capacity of that
                 slice, sends each expert's rows to the rank that holds
                 it (an all-to-all over "model"), runs its local experts,
                 sends the results back, combines them and all-gathers
                 the slices; the aux loss is the mean of the slices'
                 Switch losses over every rank. Where JAX's
                 ``_ep_applicable`` is false under a mesh, ``ep`` runs
                 JAX's fall-through: the expert blocks and the data
                 ranks' tokens gathered, then ``dispatch`` over the whole
                 batch. Without a mesh ``ep`` runs ``dispatch``.

Under an active mesh (``parallel.context.mesh_context``; the sharded
train step and prefill, ``parallel.step``) ``ep`` and ``dispatch`` take
this rank's rows of the batch (its data block) and this rank's blocks of
the layer's parameters under ``parallel.sharding.lm_param_specs``: the
router's (D, E / mp) and the experts' (E / mp, D, F). Their output is
this rank's rows. ``dispatch`` there runs what JAX's jitted ``dispatch``
computes over a batch split on the data axes: the capacity of the whole
batch (the fall-through above). ``dense`` combines the experts it is
given on the rank's rows: every expert, gathered at use
(``parallel.step.gather_at_use``). Its gradients follow ``parallel.context``'s convention (a rank's
gradient is its data replica's; the step takes the mean over the data
axes).

Router: top-k softmax gating with renormalization (Mixtral/OLMoE style) and
the Switch load-balancing auxiliary loss. The router weights stay f32
whatever the experts' dtype.

Two orders are JAX's and not PyTorch's defaults:

* the top-k keeps the lower expert among tied probabilities, as
  ``lax.top_k`` does (``torch.topk`` promises no order among ties), so the
  top-k is a stable descending sort;
* the combine adds each token's ``top_k`` contributions one after another
  in ascending expert order, in the activations' dtype: the order of JAX's
  scatter-add on the CPU (its updates sorted by expert). A scatter-add
  with ``index_add_`` would add with atomics on a CUDA tensor and not
  repeat; this order repeats bit for bit on every device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import context as ctx

from .layers import he_init

__all__ = ["MoEConfig", "init_moe_params", "moe_block"]

IMPLS = ("dense", "dispatch", "ep")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                        # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    impl: str = "dense"              # dense | dispatch | ep


def init_moe_params(gen: torch.Generator, mcfg: MoEConfig, d_model: int,
                    length: int,
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A run of ``length`` layers' MoE parameters, drawn with ``gen`` on
    its device: the f32 router (length, D, E) and the experts' SwiGLU
    weights in ``dtype``."""
    e, f = mcfg.n_experts, mcfg.d_ff
    return {
        "router": he_init(gen, (length, d_model, e), d_model, torch.float32),
        "w_gate": he_init(gen, (length, e, d_model, f), d_model, dtype),
        "w_up": he_init(gen, (length, e, d_model, f), d_model, dtype),
        "w_down": he_init(gen, (length, e, f, d_model), f, dtype),
    }


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest values in
    descending order, the lower index first among equal values (a stable
    descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x2d, router, mcfg: MoEConfig):
    """(renormalized gates (T, K) f32, expert ids (T, K), aux loss)."""
    logits = x2d.float() @ router                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, mcfg.top_k)                # (T, K)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    # Switch aux loss: E * sum_e f_e * P_e (the counts are exact in f32)
    t = x2d.shape[0]
    ids = topi.reshape(-1)
    f_e = torch.zeros(mcfg.n_experts, dtype=torch.int64,
                      device=ids.device).index_add_(
        0, ids, torch.ones_like(ids)).float() / (t * mcfg.top_k)
    p_e = probs.mean(dim=0)
    aux = mcfg.n_experts * torch.sum(f_e * p_e)
    return topv, topi, aux


def _moe_dense(x2d, p, mcfg: MoEConfig, topv, topi):
    """Every expert on every token. The expert products run as (E, T, .)
    batched matmuls, which read each weight once (an einsum over "td,edf"
    would copy the weights into another layout first)."""
    gates = torch.zeros((x2d.shape[0], mcfg.n_experts), dtype=x2d.dtype,
                        device=x2d.device).scatter_(
        1, topi, topv.to(x2d.dtype))                     # (T, E)
    hg = torch.matmul(x2d, p["w_gate"])                  # (E, T, F)
    hu = torch.matmul(x2d, p["w_up"])
    hd = torch.bmm(F.silu(hg) * hu, p["w_down"])         # (E, T, D)
    return torch.einsum("etd,te->td", hd, gates)


def capacity(t: int, mcfg: MoEConfig) -> int:
    """Each expert's buffer rows for ``t`` tokens: ceil(T * K / E * cf),
    rounded up to a multiple of 8, at least 8."""
    cap = int(math.ceil(t * mcfg.top_k / mcfg.n_experts
                        * mcfg.capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


def _dispatch_tables(x2d, mcfg: MoEConfig, topv, topi, cap):
    """Sort-by-expert dispatch bookkeeping: the flat (token, expert)
    assignments sorted by expert (stable: by token within an expert), as
    (token, gate, valid, buffer slot, sort order). An assignment past its
    expert's capacity is not valid and goes to the scratch slot E * cap."""
    t = x2d.shape[0]
    e, k = mcfg.n_experts, mcfg.top_k
    flat_e = topi.reshape(-1)
    flat_t = torch.arange(t, device=x2d.device).repeat_interleave(k)
    flat_w = topv.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    st, sw = flat_t[order], flat_w[order]
    pos = torch.arange(t * k, device=x2d.device) - torch.searchsorted(
        se, se, side="left")
    valid = pos < cap
    slot = torch.where(valid, se * cap + pos, e * cap)
    return st, sw, valid, slot, order


def _dispatch_in(x2d, mcfg: MoEConfig, topv, topi, cap):
    """The (E * cap, D) expert buffer of ``x2d``'s assignments and what
    ``_combine`` needs to bring the experts' rows back."""
    t, d = x2d.shape
    e = mcfg.n_experts
    # each token's K assignments in ascending expert order: a token's
    # experts are distinct, so the stable sort by expert orders the same
    # tables by token within an expert whatever the order within a token,
    # and the contributions come back in ascending expert order
    topi, by_expert = torch.sort(topi, dim=-1)
    topv = topv.gather(1, by_expert)
    st, sw, valid, slot, order = _dispatch_tables(x2d, mcfg, topv, topi, cap)
    buf = x2d.new_zeros((e * cap + 1, d))
    buf[slot] = x2d[st]                                  # overflow -> scratch
    return buf[:-1], (sw, valid, slot, order, cap)


def _experts(xe, p):
    """The experts' SwiGLU over their (E, C, D) rows, as batched
    matmuls."""
    hg = torch.bmm(xe, p["w_gate"])
    hu = torch.bmm(xe, p["w_up"])
    return torch.bmm(F.silu(hg) * hu, p["w_down"])       # (E, C, D)


def _combine(rows, tables, mcfg: MoEConfig, t: int):
    """The (T, D) output from the experts' (E * cap, D) rows: each
    assignment's row times its gate (0 when dropped), back at its (token,
    expert rank) place, then each token's K contributions added one after
    another in the rows' dtype."""
    sw, valid, slot, order, cap = tables
    e, k = mcfg.n_experts, mcfg.top_k
    out_rows = rows[torch.clamp_max(slot, e * cap - 1)]
    contrib = out_rows * (sw * valid).to(rows.dtype)[:, None]
    per_token = torch.empty_like(contrib)
    per_token[order] = contrib
    per_token = per_token.reshape(t, k, -1)
    y = per_token[:, 0]
    for j in range(1, k):
        y = y + per_token[:, j]
    return y


def _moe_dispatch(x2d, p, mcfg: MoEConfig, topv, topi):
    t, d = x2d.shape
    cap = capacity(t, mcfg)
    buf, tables = _dispatch_in(x2d, mcfg, topv, topi, cap)
    ye = _experts(buf.reshape(mcfg.n_experts, cap, d), p)
    return _combine(ye.reshape(-1, d), tables, mcfg, t)


def _ep_applicable(x, mcfg: MoEConfig, mesh) -> bool:
    """JAX's ``_ep_applicable`` on this rank's rows ``x`` (B / dp, S, D):
    a "model" axis that divides the experts, and at least 8 of the data
    rank's tokens a model rank, evenly. (JAX's check that the data axes
    divide the batch holds here: each data rank has its own rows.)"""
    if "model" not in mesh.axis_names:
        return False
    mp = mesh.shape["model"]
    if mcfg.n_experts % mp:
        return False
    t_loc = x.shape[0] * x.shape[1]
    return t_loc % mp == 0 and t_loc // mp >= 8


def _moe_ep(x, p, mcfg: MoEConfig, mesh):
    """Expert parallelism (JAX's ``_moe_ep_shardmap``) on this rank's rows
    ``x`` (B / dp, S, D), the router's block (D, E / mp) and the local
    experts (E / mp, D, F). The collectives' payload per layer is
    O(tokens * D). At mp = 1 every collective is the identity and the
    block runs ``dispatch``'s operations in ``dispatch``'s order."""
    mp = mesh.shape["model"]
    e_loc = mcfg.n_experts // mp
    b, s, d = x.shape
    t_mp = b * s // mp
    xs = ctx.take_block(mesh, x.reshape(b * s, d), "model", 0)
    router = ctx.gather_partial(mesh, p["router"], "model", 1)
    topv, topi, aux = _route(xs, router, mcfg)
    cap = capacity(t_mp, mcfg)
    buf, tables = _dispatch_in(xs, mcfg, topv, topi, cap)
    recv = ctx.all_to_all(mesh, buf.reshape(mp, e_loc, cap, d), "model")
    xe = recv.transpose(0, 1).reshape(e_loc, mp * cap, d)
    ye = _experts(xe, p)
    back = ye.reshape(e_loc, mp, cap, d).transpose(0, 1).reshape(
        mp, e_loc, cap, d)
    ret = ctx.all_to_all(mesh, back, "model")
    y_mp = _combine(ret.reshape(-1, d), tables, mcfg, t_mp)
    y = ctx.gather_replicated(mesh, y_mp, "model", 0)
    return y.reshape(b, s, d), ctx.pmean(mesh, aux)


def _moe_gathered(x, p, mcfg: MoEConfig, mesh):
    """JAX's fall-through under a mesh where EP does not apply: its
    ``dispatch`` runs on the whole batch with every expert. Every rank
    gathers the data ranks' rows and the parameters' blocks, runs it, and
    keeps its own rows."""
    dp = tuple(a for a in mesh.axis_names if a in ctx.DP_AXES)
    b = x.shape[0]
    xg = ctx.gather_partial(mesh, x, dp, 0)
    if "model" in mesh.axis_names:
        p = {"router": ctx.gather_replicated(mesh, p["router"], "model", 1),
             **{w: ctx.gather_replicated(mesh, p[w], "model", 0)
                for w in ("w_gate", "w_up", "w_down")}}
    bg, s, d = xg.shape
    x2d = xg.reshape(bg * s, d)
    topv, topi, aux = _route(x2d, p["router"], mcfg)
    y = _moe_dispatch(x2d, p, mcfg, topv, topi).reshape(bg, s, d)
    start = mesh.axis_index(dp) * b
    return y[start:start + b], aux


def moe_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
              mcfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (B, S, D), plus the scalar f32 aux loss. ``ep``
    under an active mesh takes this rank's rows and parameter blocks (the
    module docstring) and runs expert parallelism, or JAX's fall-through
    where it does not apply; ``dispatch`` under a mesh runs the
    fall-through; without a mesh both run ``dispatch``."""
    if mcfg.impl not in IMPLS:
        raise ValueError(f"unknown moe impl {mcfg.impl!r}")
    if mcfg.impl != "dense":
        mesh = ctx.active_mesh()
        if mesh is not None:
            if mcfg.impl == "ep" and _ep_applicable(x, mcfg, mesh):
                return _moe_ep(x, p, mcfg, mesh)
            return _moe_gathered(x, p, mcfg, mesh)
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    topv, topi, aux = _route(x2d, p["router"], mcfg)
    if mcfg.impl == "dense":
        y = _moe_dense(x2d, p, mcfg, topv, topi)
    else:
        y = _moe_dispatch(x2d, p, mcfg, topv, topi)
    return y.reshape(b, s, d), aux
