"""tinyllama-1.1b [dense] 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small [arXiv:2401.02385; hf]."""
import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
    n_kv_heads=4, d_head=64, d_ff=5632, vocab=32000, rope_theta=10000.0,
    tie_embeddings=False, dtype=torch.bfloat16)

SMOKE = LMConfig(
    name="tinyllama-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=256, tie_embeddings=False,
    seq_chunk=16, q_chunk=16, kv_chunk=16)


def get_arch():
    from repro_torch.configs.lm_family import make_lm_arch
    return make_lm_arch("tinyllama-1.1b", CONFIG, SMOKE, long_ok=False)
