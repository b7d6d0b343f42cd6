"""LM-family ``ArchSpec`` builder (port of ``repro.configs.lm_family``):
train_4k / prefill_32k / decode_32k / long_500k cells for the five
transformer architectures, their parameter count and per-shape MoE
implementation.

Every cell's rank program runs on the card's attention route, K5
(``attn_impl="flash"``), with the parameters under ``lm_param_specs``:
the train cells' is ``parallel.step.make_sharded_train_step`` (the ZeRO-1
moments, the rows over the data axes), the prefill cells'
``make_sharded_prefill`` and the decode cells' ``make_sharded_decode_step``
(the KV cache under ``lm_cache_specs``: a run of 8192 slots or more split
on its sequence, decode attention merged across the ranks that hold its
blocks).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from repro_torch._device import DeviceLike, cpu_generator, resolve_device
from repro_torch._tree import tree_map
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import LMConfig
from repro_torch.optim import AdamWConfig, init_opt_state, make_train_step

from .common import ArchSpec, ShapeDef, abstract_tensor, abstract_tree

__all__ = ["make_lm_arch", "LM_SHAPES", "lm_param_count", "shape_config",
           "smoke"]

LM_SHAPES = {
    "train_4k": dict(kind="train", batch=256, seq=4096),
    "prefill_32k": dict(kind="prefill", batch=32, seq=32768),
    "decode_32k": dict(kind="decode", batch=128, seq=32768),
    "long_500k": dict(kind="decode", batch=1, seq=524288),
}


def lm_param_count(cfg: LMConfig, active_only: bool = False) -> float:
    d, dh = cfg.d_model, cfg.d_head
    attn = d * cfg.n_heads * dh * 2 + d * cfg.n_kv_heads * dh * 2
    if cfg.moe is None:
        mlp = 3 * d * cfg.d_ff
    else:
        e = cfg.moe.top_k if active_only else cfg.moe.n_experts
        mlp = 3 * d * cfg.moe.d_ff * e + d * cfg.moe.n_experts
    emb = cfg.vocab_padded * d * (1 if cfg.tie_embeddings else 2)
    return float(cfg.n_layers * (attn + mlp + 2 * d) + emb + d)


def _with_moe_impl(cfg: LMConfig, impl: str) -> LMConfig:
    if cfg.moe is None or cfg.moe.impl == impl:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl=impl))


def shape_config(cfg: LMConfig, kind: str) -> LMConfig:
    """The configuration a shape of ``kind`` (train | prefill | decode)
    runs, as JAX's ``make_lm_arch`` picks it: decode's tiny token counts
    take the ``dense`` MoE combine, train and prefill the configured
    implementation. A dense configuration is returned as it is."""
    if kind == "decode":
        return _with_moe_impl(cfg, "dense")
    return cfg


_ADAM = AdamWConfig(lr=3e-4, total_steps=100_000)

def smoke(c: LMConfig, device: DeviceLike = None) -> Dict[str, object]:
    """JAX's LM ``arch.smoke()`` on ``c`` (a SMOKE config): one AdamW train
    step with the dispatch MoE, a prefill of 2 x 32 tokens and one decode
    step. Returns ``{"ok", "loss", "logits_shape", "expect_vocab"}``. Runs
    on ``cuda`` unless ``device`` names another device."""
    dev = resolve_device(device)
    params = tf.lm_init_params(c, seed=0, device=dev)
    b, s = 2, 32
    toks = torch.randint(0, c.vocab, (b, s), generator=cpu_generator(1),
                         dtype=torch.int32).to(dev)
    tc = _with_moe_impl(c, "dispatch")
    step = make_train_step(lambda p, batch: tf.lm_train_forward(p, tc,
                                                                batch),
                           _ADAM)
    # a copy: the port's AdamW updates in place, and the serve calls
    # below read the initial parameters as JAX's do
    trained = tree_map(lambda t: t.detach().clone(), params)
    loss, _, _ = step(trained, init_opt_state(trained),
                      {"tokens": toks, "labels": toks})
    cache = tf.init_cache(c, b, s + 4, device=dev)
    logits, cache = tf.lm_prefill(params, c, toks, cache)
    nxt = torch.argmax(logits[:, :c.vocab], dim=-1).to(torch.int32)
    logits2, _ = tf.lm_decode_step(params, c, nxt, s, cache)
    ok = bool(torch.isfinite(loss)) and bool(torch.all(torch.isfinite(
        logits2)))
    return {"ok": ok, "loss": float(loss),
            "logits_shape": tuple(logits2.shape),
            "expect_vocab": c.vocab_padded}


def make_lm_arch(name: str, cfg: LMConfig, smoke_cfg: LMConfig,
                 long_ok: bool, long_skip_reason: str = "",
                 zero_opt: bool = True,
                 shapes: Optional[Dict[str, dict]] = None) -> ArchSpec:
    """``zero_opt``: shard Adam moments over the DP axes as well (ZeRO-1),
    as JAX's. ``shapes`` (default ``LM_SHAPES``) may cut a cell's batch
    and sequence (the dry-run's cuts)."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.sharding import P
    table = LM_SHAPES if shapes is None else shapes
    shape_defs = {}
    for sname, s in table.items():
        skip = None
        if sname == "long_500k" and not long_ok:
            skip = long_skip_reason or (
                "pure full attention on every layer: no sub-quadratic "
                "structure for 512k decode (DESIGN.md §4)")
        shape_defs[sname] = ShapeDef(name=sname, kind=s["kind"], skip=skip,
                                     desc=f"B={s['batch']} S={s['seq']}")

    def shape_cfg(sname) -> LMConfig:
        return shape_config(cfg, table[sname]["kind"])

    @functools.lru_cache(maxsize=None)
    def abstract_params():
        """The full parameters as fake tensors (the ZeRO specs read their
        shapes)."""
        return abstract_tree(lambda: tf.lm_init_params(cfg, 0, "cpu"),
                             "meta")

    def abstract_args(sname: str, device: DeviceLike = "meta"):
        s = table[sname]
        params = abstract_tree(lambda: tf.lm_init_params(cfg, 0, "cpu"),
                               device)
        b, seq = s["batch"], s["seq"]
        i32 = torch.int32
        if s["kind"] == "train":
            opt = abstract_tree(lambda: init_opt_state(params), device)
            batch = {"tokens": abstract_tensor((b, seq), i32, device),
                     "labels": abstract_tensor((b, seq), i32, device)}
            return (params, opt, batch)
        cache = abstract_tree(lambda: tf.init_cache(cfg, b, seq,
                                                    device="cpu"), device)
        if s["kind"] == "prefill":
            return (params, abstract_tensor((b, seq), i32, device), cache)
        return (params, abstract_tensor((b,), i32, device),
                abstract_tensor((), i32, device), cache)

    def _ospec(pspec, mesh):
        if zero_opt:
            return sh.zero_opt_specs(abstract_params(), pspec, mesh)
        return sh.opt_specs(pspec)

    def arg_specs(sname: str, mesh):
        s = table[sname]
        pspec = sh.lm_param_specs(cfg)
        b_ax = sh.batch_axes(mesh, s["batch"])
        if s["kind"] == "train":
            bspec = {"tokens": P(b_ax, None), "labels": P(b_ax, None)}
            return (pspec, _ospec(pspec, mesh), bspec)
        cspec = sh.lm_cache_specs(cfg, mesh, s["batch"], s["seq"])
        if s["kind"] == "prefill":
            return (pspec, P(b_ax, None), cspec)
        return (pspec, P(b_ax), P(), cspec)

    def out_specs(sname: str, mesh):
        s = table[sname]
        pspec = sh.lm_param_specs(cfg)
        if s["kind"] == "train":
            return (P(), pspec, _ospec(pspec, mesh))
        b_ax = sh.batch_axes(mesh, s["batch"])
        cspec = sh.lm_cache_specs(cfg, mesh, s["batch"], s["seq"])
        return (P(b_ax, "model"), cspec)     # logits vocab-sharded

    def step_fn(sname: str, mesh):
        """The cell's rank program on the rank's blocks (K5 attention, the
        shape's MoE implementation): the sharded train step, prefill or
        decode step."""
        from repro_torch.parallel import step as pstep
        s = table[sname]
        c = dataclasses.replace(shape_cfg(sname), attn_impl="flash")
        pspec = sh.lm_param_specs(cfg)
        if s["kind"] == "train":
            return pstep.make_sharded_train_step(c, _ADAM, mesh, pspec,
                                                 _ospec(pspec, mesh))
        cspec = sh.lm_cache_specs(cfg, mesh, s["batch"], s["seq"])
        if s["kind"] == "prefill":
            return pstep.make_sharded_prefill(c, mesh, pspec, cspec)
        return pstep.make_sharded_decode_step(c, mesh, pspec, cspec)

    def model_flops(sname: str) -> float:
        s = table[sname]
        n_active = lm_param_count(cfg, active_only=True)
        tokens = s["batch"] * (s["seq"] if s["kind"] in ("train", "prefill")
                               else 1)
        mult = 6.0 if s["kind"] == "train" else 2.0   # fwd+bwd vs fwd
        return mult * n_active * tokens

    return ArchSpec(
        name=name, family="lm", shapes=shape_defs,
        abstract_args=abstract_args, arg_specs=arg_specs,
        out_specs=out_specs, step_fn=step_fn,
        smoke=lambda device=None: smoke(smoke_cfg, device),
        model_flops=model_flops)
