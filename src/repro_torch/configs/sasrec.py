"""sasrec [recsys] embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq [arXiv:1808.09781; paper].

Catalog sized 2^20 so the retrieval_cand cell scores the full catalog."""
from repro_torch.models.recsys import SASRecConfig

CONFIG = SASRecConfig(name="sasrec", n_items=1_048_576, embed_dim=50,
                      n_blocks=2, n_heads=1, seq_len=50)
