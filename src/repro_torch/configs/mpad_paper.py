"""The paper's own experiment configuration (Section 4), a copy of
``repro.configs.mpad_paper`` for the port.

Parameter grids exactly as published:
  target ratios [0.05, 0.1, 0.2, 0.4, 0.6], k in [1, 3, 6, 10, 15],
  alpha in [1, 6, 12, 18, 25, 35, 50, 10000], b in [60, 70, 80, 90, 100]
  => 1000 settings per dataset (40 MPAD configs x 25 global combos).

Datasets are synthetic stand-ins matched to Table 4 (see
``repro_torch.data.synthetic``); per-dataset fixed (alpha, b) for the
Fig. 1 protocol follow the paper (alpha=50, b=80 for fasttext; defaults
elsewhere).
"""
from repro_torch.core.mpad import MPADConfig

__all__ = ["TARGET_RATIOS", "K_VALUES", "ALPHA_GRID", "B_GRID",
           "FIXED_PARAMS", "SAMPLING", "mpad_config"]

TARGET_RATIOS = [0.05, 0.1, 0.2, 0.4, 0.6]
K_VALUES = [1, 3, 6, 10, 15]
ALPHA_GRID = [1.0, 6.0, 12.0, 18.0, 25.0, 35.0, 50.0, 10000.0]
B_GRID = [60.0, 70.0, 80.0, 90.0, 100.0]

# fixed per-dataset (alpha, b) used for the Fig.1 average-accuracy protocol
FIXED_PARAMS = {
    "fasttext": (50.0, 80.0),        # stated in the paper
    "isolet": (25.0, 80.0),
    "arcene": (25.0, 80.0),
    "pbmc3k": (25.0, 80.0),
}

# Table 4 sampling protocol: sample dim / train size / test size
SAMPLING = {
    "fasttext": dict(dim=300, train=600, test=600),
    "isolet": dict(dim=200, train=600, test=600),
    "arcene": dict(dim=200, train=600, test=297),
    "pbmc3k": dict(dim=200, train=600, test=600),
}


def mpad_config(dataset: str, m: int, iters: int = 48) -> MPADConfig:
    alpha, b = FIXED_PARAMS[dataset]
    return MPADConfig(m=m, alpha=alpha, b=b, iters=iters, backend="fast")
