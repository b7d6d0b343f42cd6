"""O(N log N) MPAD objective: sorted prefix sums and a bisected quantile
threshold (port of ``repro.core.fast_objective``).

For scalar projections p = X w, the mean of the smallest b% of the
pairwise |p_i - p_j| follows from the sorted projections: pairs within a
threshold t are counted with ``searchsorted``, the b%-quantile threshold is
found by 60 steps of monotone bisection, and the value and per-point
gradient coefficients come from prefix sums. Every step stays on the
device; nothing syncs with the host.

Pair counts are int64 here (the JAX version counts in int32 up to
N = 46,340 and in f32 above, where it is no longer exact); the two agree
wherever the JAX count is exact.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .objective import num_selected_pairs, penalized

__all__ = ["ThresholdStats", "threshold_stats", "find_quantile_threshold",
           "mu_b_fast", "mu_b_fast_value_and_grad", "phi_fast_value_and_grad"]

_BISECT_ITERS = 60


class ThresholdStats(NamedTuple):
    """Statistics of the pair set {(i, j) : |p_i - p_j| <= tau}."""
    count: torch.Tensor   # int64 scalar: number of such pairs
    sum: torch.Tensor     # f32 scalar: sum of |p_i - p_j| over the set
    coeff: torch.Tensor   # (N,) f32: #{j: p_j < p_i, within} - #{j: p_j > p_i, within}
    tau: torch.Tensor     # the threshold used


def _sorted_prefix(p: torch.Tensor):
    order = torch.argsort(p, stable=True)
    ps = p[order]
    prefix = torch.cat([ps.new_zeros(1), torch.cumsum(ps, dim=0)])
    return ps, prefix, order


def _count_below(ps: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """#pairs (i < j in sorted order) with ps[j] - ps[i] <= t."""
    lo = torch.searchsorted(ps, ps - t, side="left")
    idx = torch.arange(ps.shape[0], device=ps.device)
    return (idx - lo).sum()


def threshold_stats(p: torch.Tensor, tau: torch.Tensor) -> ThresholdStats:
    """Exact count / sum / gradient coefficients for pairs with d <= tau."""
    n = p.shape[0]
    ps, prefix, order = _sorted_prefix(p)
    idx = torch.arange(n, device=p.device)
    lo = torch.searchsorted(ps, ps - tau, side="left")
    hi = torch.searchsorted(ps, ps + tau, side="right")
    below = idx - lo                  # j < i (sorted) within tau
    above = hi - idx - 1              # j > i (sorted) within tau
    count = below.sum()
    # sum over {j < i} of (ps[i] - ps[j]) = below*ps[i] - (prefix[i] - prefix[lo])
    s = (below * ps - (prefix[idx] - prefix[lo])).sum()
    c_sorted = (below - above).to(p.dtype)
    coeff = torch.zeros_like(p).scatter_(0, order, c_sorted)
    return ThresholdStats(count=count, sum=s, coeff=coeff, tau=tau)


def find_quantile_threshold(p: torch.Tensor, k_pairs: int) -> torch.Tensor:
    """Smallest tau with count(tau) >= k_pairs, by monotone bisection."""
    ps = torch.sort(p).values
    lo = torch.zeros((), dtype=p.dtype, device=p.device)
    hi = (ps[-1] - ps[0]) + torch.tensor(1e-12, dtype=p.dtype,
                                         device=p.device)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        take_hi = _count_below(ps, mid) >= k_pairs
        lo, hi = torch.where(take_hi, lo, mid), torch.where(take_hi, mid, hi)
    return hi


def _mu_fast_impl(w: torch.Tensor, x: torch.Tensor, *, b: float):
    k_pairs = num_selected_pairs(x.shape[0], b)
    wn = w / torch.linalg.vector_norm(w)
    p = x @ wn
    tau = find_quantile_threshold(p, k_pairs)
    st = threshold_stats(p, tau)
    cnt = st.count.clamp_min(1).to(p.dtype)
    # exact tie correction: drop the (count - k) excess pairs, all == tau
    kf = float(k_pairs)
    excess = cnt - kf
    value = (st.sum - excess * st.tau) / kf
    g_raw = (x.T @ st.coeff) / cnt
    g = g_raw - torch.dot(g_raw, wn) * wn   # tangent projection
    return value, g, st


def mu_b_fast_value_and_grad(w: torch.Tensor, x: torch.Tensor, *,
                             b: float):
    """mu_b at ``w`` and its tangent gradient (the direction's norm
    factored out), from the sorted prefix sums."""
    value, g, _ = _mu_fast_impl(w, x, b=b)
    return value, g


class _MuFast(torch.autograd.Function):
    """The exact fast value; its backward is the subgradient (the JAX
    package's custom VJP): ``g * ct`` for w and ``(c_i / count) * w_hat *
    ct`` for each row x_i."""

    @staticmethod
    def forward(ctx, w, x, b):
        value, g, st = _mu_fast_impl(w, x, b=b)
        ctx.save_for_backward(g, st.coeff, st.count,
                              w / torch.linalg.vector_norm(w))
        return value

    @staticmethod
    def backward(ctx, ct):
        g, coeff, count, wn = ctx.saved_tensors
        cnt = count.clamp_min(1).to(g.dtype)
        gx = (coeff[:, None] / cnt) * wn[None, :] * ct
        return g * ct, gx, None


def mu_b_fast(w: torch.Tensor, x: torch.Tensor, *, b: float
              ) -> torch.Tensor:
    """Differentiable fast mu_b (an ``autograd.Function``: the exact
    value, the subgradient)."""
    return _MuFast.apply(w, x, b)


def phi_fast_value_and_grad(w: torch.Tensor, x: torch.Tensor,
                            prev: torch.Tensor, prev_mask: torch.Tensor, *,
                            b: float, alpha: float):
    """Value and tangent gradient of
    phi = mu_b(w) - alpha * sum_j mask_j (w_j . w)^2.

    ``prev`` is a fixed-size (m, n) buffer of the directions chosen so far,
    ``prev_mask`` marks its valid rows.
    """
    mu, g_mu, _ = _mu_fast_impl(w, x, b=b)
    return penalized(mu, g_mu, w, prev, prev_mask, alpha)
