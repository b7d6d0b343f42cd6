"""olmoe-1b-7b [moe] 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_head=128, d_ff=0, vocab=50304, rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024, capacity_factor=1.25,
                  impl="ep"),
    tie_embeddings=False, dtype=torch.bfloat16)

SMOKE = LMConfig(
    name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=0, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, capacity_factor=2.0,
                  impl="dispatch"),
    tie_embeddings=False, seq_chunk=16, q_chunk=16, kv_chunk=16)


def get_arch():
    from repro_torch.configs.lm_family import make_lm_arch
    return make_lm_arch("olmoe-1b-7b", CONFIG, SMOKE, long_ok=False)
