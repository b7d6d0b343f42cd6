"""granite-moe-1b-a400m [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base;
hf]. vocab padded 49155 -> 49408 (multiple of 256)."""
import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=8, d_head=64, d_ff=0, vocab=49155, rope_theta=10000.0,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff=512, capacity_factor=1.25,
                  impl="ep"),
    tie_embeddings=True, dtype=torch.bfloat16)

SMOKE = LMConfig(
    name="granite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=0, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, capacity_factor=2.0,
                  impl="dispatch"),
    tie_embeddings=True, seq_chunk=16, q_chunk=16, kv_chunk=16)


def get_arch():
    from repro_torch.configs.lm_family import make_lm_arch
    return make_lm_arch("granite-moe-1b-a400m", CONFIG, SMOKE, long_ok=False)
