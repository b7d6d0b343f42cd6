"""Paper-faithful MPAD objective (port of ``repro.core.objective``, Algorithm
1, Section 3.4), and the pieces the fit backends share.

``mu_b_exact`` is the oracle: it materializes all N(N-1)/2 pairwise
absolute differences of the scalar projections, selects the smallest b%
and averages them, exactly as written in the paper. O(N^2) memory. It is
the ``exact`` backend of the fit and the reference of the ``fast`` and
``kernel`` ones.
"""
from __future__ import annotations

import torch

__all__ = ["num_selected_pairs", "pairwise_abs_diff", "mu_b_exact",
           "mu_b_exact_value_and_grad", "orthogonality_penalty", "phi_exact",
           "penalized"]


def num_selected_pairs(n_points: int, b: float) -> int:
    """|D_b|: how many of the N(N-1)/2 pairs fall in the smallest b%."""
    total = n_points * (n_points - 1) // 2
    return max(1, int(total * (b / 100.0)))


def pairwise_abs_diff(p: torch.Tensor) -> torch.Tensor:
    """All N(N-1)/2 pairwise |p_i - p_j| as a flat vector (upper triangle,
    row-major)."""
    n = p.shape[0]
    iu, ju = torch.triu_indices(n, n, offset=1, device=p.device)
    return (p[iu] - p[ju]).abs()


def mu_b_exact(w: torch.Tensor, x: torch.Tensor, *, b: float) -> torch.Tensor:
    """mu_b(w): mean of the smallest b% of pairwise |<w, x_i - x_j>|.

    Differentiable: autograd flows to the selected pairs only (the paper's
    subgradient). The selection follows ``lax.top_k``'s order, so among
    pairs tied at the cut the lower ones are kept, as in JAX; the value
    does not depend on that choice.
    """
    # imported here: repro_torch.search imports the fit, which imports this
    from repro_torch.search.knn import topk_smallest
    w = w / torch.linalg.vector_norm(w)
    p = x @ w
    d = pairwise_abs_diff(p)
    k = num_selected_pairs(x.shape[0], b)
    smallest, _ = topk_smallest(d[None, :], k)
    return smallest.mean()


def mu_b_exact_value_and_grad(w: torch.Tensor, x: torch.Tensor, *,
                              b: float):
    """(mu_b(w), its gradient in w) by autograd."""
    with torch.enable_grad():
        w = w.detach().requires_grad_(True)
        val = mu_b_exact(w, x, b=b)
        (grad,) = torch.autograd.grad(val, w)
    return val.detach(), grad


def orthogonality_penalty(w: torch.Tensor, prev: torch.Tensor,
                          alpha: float) -> torch.Tensor:
    """P_orth = alpha * sum_j (w_j . w)^2 over previously chosen rows
    ``prev`` (k-1, n); an empty (0, n) matrix gives zero."""
    if prev.shape[0] == 0:
        return torch.zeros((), dtype=w.dtype, device=w.device)
    dots = prev @ w
    return alpha * (dots * dots).sum()


def phi_exact(w: torch.Tensor, x: torch.Tensor, prev: torch.Tensor, *,
              b: float, alpha: float) -> torch.Tensor:
    """phi(w_k) = mu_b(w_k) - alpha * sum_{j<k} (w_j . w_k)^2 (paper eq.,
    Sec 3.4)."""
    return mu_b_exact(w, x, b=b) - orthogonality_penalty(w, prev, alpha)


def penalized(mu: torch.Tensor, g_mu: torch.Tensor, w: torch.Tensor,
              prev: torch.Tensor, prev_mask: torch.Tensor, alpha: float):
    """phi = mu - alpha * sum_j mask_j (w_j . w)^2 and its tangent gradient
    from mu's: the orthogonality part of every backend. ``prev`` is a
    fixed-size (m, n) buffer of the directions chosen so far,
    ``prev_mask`` marks its valid rows."""
    wn = w / torch.linalg.vector_norm(w)
    dots = (prev @ wn) * prev_mask
    pen = alpha * (dots * dots).sum()
    g_pen_raw = 2.0 * alpha * (prev.T @ (dots * prev_mask))
    g_pen = g_pen_raw - torch.dot(g_pen_raw, wn) * wn
    return mu - pen, g_mu - g_pen
