"""Cross-entropy oracles (port of ``repro.kernels.fused_ce.ref``) and the
plain version of kernel K6.

``ce_ref`` materializes the (T, V) logits in f32. ``fused_ce_fwd_plain``
computes the same per-token loss as K6 does, tile by tile: an online
logsumexp over vocab tiles with the padded tail masked to -1e30, the
gold logit picked out of the tile that holds the label, and
``(m + log(max(s, 1e-30))) - gold`` at the end.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ce_ref", "fused_ce_fwd_plain"]

_NEG_INF = -1e30


def ce_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
           vocab: Optional[int] = None) -> torch.Tensor:
    """h (T, D), w (D, V), labels (T,) -> per-token loss (T,) f32.

    ``vocab``: the logical vocab (<= V); the padded tail is masked out."""
    logits = h.float() @ w.float()
    if vocab is not None and vocab < w.shape[1]:
        col = torch.arange(w.shape[1], device=w.device)
        logits = torch.where(col < vocab, logits, _NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return lse - gold


def fused_ce_fwd_plain(h: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor, vocab: Optional[int] = None,
                       block_v: int = 4096) -> torch.Tensor:
    """K6's function in plain PyTorch: per-token ``logsumexp(h @ w)`` over
    the columns < ``vocab`` minus the gold logit, over vocab tiles of
    ``block_v`` columns (no (T, V) tensor). h and w are upcast to f32;
    returns (T,) f32. A label outside [0, V) contributes a gold logit of
    0, as the TPU kernel's one-hot sum gives."""
    t, v = h.shape[0], w.shape[1]
    vocab = v if vocab is None else vocab
    h32 = h.float()
    lab = labels.long()
    m = torch.full((t,), _NEG_INF, dtype=torch.float32, device=h.device)
    s = torch.zeros((t,), dtype=torch.float32, device=h.device)
    g = torch.zeros((t,), dtype=torch.float32, device=h.device)
    for v0 in range(0, v, block_v):
        logits = h32 @ w[:, v0:v0 + block_v].float()
        col = torch.arange(v0, v0 + logits.shape[1], device=h.device)
        logits = torch.where(col < vocab, logits, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=1)
        m = m_new
        hit = col[None, :] == lab[:, None]
        g = g + torch.where(hit, logits, 0.0).sum(dim=1)
    return (m + torch.log(torch.clamp_min(s, 1e-30))) - g
