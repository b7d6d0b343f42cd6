"""autoint [recsys] n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32 interaction=self-attn [arXiv:1810.11921; paper].

Criteo-like: 39 sparse fields, 100k hash vocab per field."""
from repro_torch._device import DeviceLike
from repro_torch.configs import recsys_family
from repro_torch.models.recsys import AutoIntConfig

CONFIG = AutoIntConfig(name="autoint", n_fields=39, vocab_per_field=100_000,
                       embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32)


def smoke(device: DeviceLike = None):
    """autoint's smoke step: ``recsys_family.smoke("autoint")``."""
    return recsys_family.smoke("autoint", device)
