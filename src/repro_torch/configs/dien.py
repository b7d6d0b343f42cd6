"""dien [recsys] embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80
interaction=augru [arXiv:1809.03672; unverified]."""
from repro_torch._device import DeviceLike
from repro_torch.configs import recsys_family
from repro_torch.models.recsys import DIENConfig

CONFIG = DIENConfig(name="dien", n_items=1_048_576, n_cats=10_000,
                    embed_dim=18, seq_len=100, gru_dim=108,
                    mlp_dims=(200, 80))


def smoke(device: DeviceLike = None):
    """dien's smoke step: ``recsys_family.smoke("dien")``."""
    return recsys_family.smoke("dien", device)
