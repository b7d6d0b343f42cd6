"""stablelm-1.6b [dense] 24L d_model=2048 32H (GQA kv=32, i.e. MHA)
d_ff=5632 vocab=100352 [hf:stabilityai/stablelm-2-1_6b; unverified]."""
import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="stablelm-1.6b", n_layers=24, d_model=2048, n_heads=32,
    n_kv_heads=32, d_head=64, d_ff=5632, vocab=100352, rope_theta=10000.0,
    tie_embeddings=False, dtype=torch.bfloat16)

SMOKE = LMConfig(
    name="stablelm-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=256, tie_embeddings=False,
    seq_chunk=16, q_chunk=16, kv_chunk=16)


def get_arch():
    from repro_torch.configs.lm_family import make_lm_arch
    return make_lm_arch("stablelm-1.6b", CONFIG, SMOKE, long_ok=False)
