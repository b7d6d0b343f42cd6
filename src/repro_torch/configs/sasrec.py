"""sasrec [recsys] embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq [arXiv:1808.09781; paper].

Catalog sized 2^20 so the retrieval_cand cell scores the full catalog."""
from repro_torch._device import DeviceLike
from repro_torch.configs import recsys_family
from repro_torch.models.recsys import SASRecConfig

CONFIG = SASRecConfig(name="sasrec", n_items=1_048_576, embed_dim=50,
                      n_blocks=2, n_heads=1, seq_len=50)


def smoke(device: DeviceLike = None):
    """sasrec's smoke step: ``recsys_family.smoke("sasrec")``."""
    return recsys_family.smoke("sasrec", device)


def get_arch():
    return recsys_family.make_sasrec_arch(CONFIG)
