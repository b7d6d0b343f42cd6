"""Plain PyTorch version of the MPAD pairwise threshold statistics (kernel
K4); port of ``repro.kernels.mpad_pairwise.ref``.

Given scalar projections ``p`` (N,) and a threshold ``tau``, over the
unordered pairs i < j with |p_i - p_j| <= tau:

  count: the number of such pairs
  sum:   the sum of |p_i - p_j|
  coeff: c_i = #{j : p_j < p_i within tau} - #{j : p_j > p_i within tau}
         (the exact subgradient coefficients: grad mu = X^T c / count)

O(N^2) dense: the spec the CUDA kernel is held against, and what the
wrapper runs on CPU tensors. ``pairwise_stats_at_quantile_ref`` is the
fused entry's: the fit's threshold (``find_quantile_threshold``), then
these statistics at it.
"""
from __future__ import annotations

import torch

from repro_torch.core.fast_objective import find_quantile_threshold

__all__ = ["pairwise_stats_ref", "pairwise_stats_at_quantile_ref"]


def pairwise_stats_ref(p: torch.Tensor, tau):
    """Returns (count int64 scalar, sum f32 scalar, coeff (N,) f32)."""
    p = p.to(torch.float32)
    n = p.shape[0]
    diff = p[:, None] - p[None, :]
    ad = diff.abs()
    neq = ~torch.eye(n, dtype=torch.bool, device=p.device)
    within = (ad <= tau) & neq
    count = within.sum() // 2
    s = torch.where(within, ad, 0.0).sum() * 0.5
    coeff = torch.where(within, torch.sign(diff), 0.0).sum(dim=1)
    return count, s, coeff


def pairwise_stats_at_quantile_ref(p: torch.Tensor, k_pairs: int):
    """The smallest tau whose pair count reaches ``k_pairs``, by the fit's
    60-step bisection, and the statistics at it. Returns (tau f32 scalar,
    count int64 scalar, sum f32 scalar, coeff (N,) f32)."""
    tau = find_quantile_threshold(p.to(torch.float32), k_pairs)
    return (tau, *pairwise_stats_ref(p, tau))
