"""MPAD pairwise threshold statistics (kernel K4): the plain PyTorch
version, the wrapper that launches the CUDA kernel, and the MPAD objective
backed by it (the fit's ``kernel`` backend)."""
from .ops import (mu_kernel_value_and_grad, pairwise_stats,
                  phi_kernel_value_and_grad)
from .ref import pairwise_stats_ref

__all__ = ["pairwise_stats", "pairwise_stats_ref",
           "mu_kernel_value_and_grad", "phi_kernel_value_and_grad"]
