"""The LM family's workload shapes, parameter count and per-shape MoE
implementation (port of the corresponding part of
``repro.configs.lm_family``; its sharding and ``ArchSpec`` lowering wait
with the model side's sharding, ROADMAP.md item 13)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import LMConfig

__all__ = ["LM_SHAPES", "lm_param_count", "shape_config"]

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
