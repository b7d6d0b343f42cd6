"""Pieces of the MPAD objective shared by the fit backends (port of the
parts of ``repro.core.objective`` the ``fast`` backend uses)."""
from __future__ import annotations

import torch

__all__ = ["num_selected_pairs", "orthogonality_penalty"]


def num_selected_pairs(n_points: int, b: float) -> int:
    """|D_b|: how many of the N(N-1)/2 pairs fall in the smallest b%."""
    total = n_points * (n_points - 1) // 2
    return max(1, int(total * (b / 100.0)))


def orthogonality_penalty(w: torch.Tensor, prev: torch.Tensor,
                          alpha: float) -> torch.Tensor:
    """P_orth = alpha * sum_j (w_j . w)^2 over previously chosen rows
    ``prev`` (k-1, n); an empty (0, n) matrix gives zero."""
    if prev.shape[0] == 0:
        return torch.zeros((), dtype=w.dtype, device=w.device)
    dots = prev @ w
    return alpha * (dots * dots).sum()
