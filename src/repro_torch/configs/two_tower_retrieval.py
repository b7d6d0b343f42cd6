"""two-tower-retrieval [recsys] embed_dim=256 tower_mlp=1024-512-256
interaction=dot — sampled-softmax retrieval [RecSys'19 (YouTube);
unverified].

The paper-native cell: retrieval serves 1 query against ~10^6 candidates
scored in MPAD-reduced space (256 -> 64) with an exact re-rank of the top
256."""
from repro_torch._device import DeviceLike
from repro_torch.configs import recsys_family
from repro_torch.models.recsys import TwoTowerConfig

CONFIG = TwoTowerConfig(name="two-tower-retrieval", n_users=5_000_000,
                        n_items=2_000_000, n_user_feats=8, field_dim=64,
                        embed_dim=256, tower_dims=(1024, 512, 256),
                        n_negatives=8192)

MPAD_DIM = 64          # reduced serving dimension (the paper's technique)
RERANK = 256


def smoke(device: DeviceLike = None):
    """two-tower-retrieval's smoke step: ``recsys_family.smoke("two-tower-retrieval")``."""
    return recsys_family.smoke("two-tower-retrieval", device)


def get_arch():
    return recsys_family.make_twotower_arch(CONFIG, mpad_dim=MPAD_DIM,
                                            rerank=RERANK)
