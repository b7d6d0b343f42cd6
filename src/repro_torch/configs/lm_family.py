"""The LM family's workload shapes and parameter count (port of the
corresponding part of ``repro.configs.lm_family``; its sharding and
``ArchSpec`` lowering are JAX-only and not ported)."""
from __future__ import annotations

from repro_torch.models.transformer import LMConfig

__all__ = ["LM_SHAPES", "lm_param_count"]

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
