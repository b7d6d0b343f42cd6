"""MPAD pairwise threshold statistics (kernel K4): the plain PyTorch
versions, the wrappers that launch the CUDA kernel (the statistics at a
given threshold, and the fit step's threshold search and statistics in one
launch), and the MPAD objective backed by them (the fit's ``kernel``
backend)."""
from .ops import (launch_floor, mu_kernel_value_and_grad, pairwise_stats,
                  pairwise_stats_at_quantile, phi_kernel_value_and_grad)
from .ref import pairwise_stats_at_quantile_ref, pairwise_stats_ref

__all__ = ["pairwise_stats", "pairwise_stats_ref",
           "pairwise_stats_at_quantile", "pairwise_stats_at_quantile_ref",
           "launch_floor", "mu_kernel_value_and_grad",
           "phi_kernel_value_and_grad"]
