"""gemma3-4b [dense] 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
— 5:1 local:global, 128k context [hf:google/gemma-3-*-pt; unverified].

head_dim=256 (gemma3 family), sliding window 1024 for local layers, rope
theta 1M global / 10k local. The 5:1 pattern ((i % 6) == 5 is global) with
window-bounded local KV caches."""
import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_head=256, d_ff=10240, vocab=262144, rope_theta=1_000_000.0,
    rope_theta_local=10_000.0, sliding_window=1024, global_every=6,
    tie_embeddings=True, dtype=torch.bfloat16)

SMOKE = LMConfig(
    name="gemma3-smoke", n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=256, sliding_window=8, global_every=3,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0, tie_embeddings=True,
    seq_chunk=16, q_chunk=16, kv_chunk=16)


def get_arch():
    from repro_torch.configs.lm_family import make_lm_arch
    return make_lm_arch("gemma3-4b", CONFIG, SMOKE, long_ok=True)
