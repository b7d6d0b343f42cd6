"""MPAD/QPAD fitting and the baseline reducers in PyTorch (the port of
``repro.core``)."""
from .baselines import (BASELINE_FITTERS, Reducer, fit_isomap, fit_kpca_rbf,
                        fit_mds, fit_pca, fit_random_projection,
                        fit_umap_lite)
from .mpad import MPADConfig, MPADResult, fit_mpad, transform
from .objective import (mu_b_exact, mu_b_exact_value_and_grad,
                        num_selected_pairs, orthogonality_penalty,
                        pairwise_abs_diff, phi_exact)

__all__ = ["MPADConfig", "MPADResult", "fit_mpad", "transform", "Reducer",
           "fit_pca", "fit_random_projection", "fit_mds", "fit_kpca_rbf",
           "fit_isomap", "fit_umap_lite", "BASELINE_FITTERS",
           "num_selected_pairs", "pairwise_abs_diff", "mu_b_exact",
           "mu_b_exact_value_and_grad", "orthogonality_penalty", "phi_exact"]
