"""Sparse embedding ops (port of ``repro.models.embedding``): a lookup
with -1 padding, an EmbeddingBag over fixed-width bags, and multiplicative
id hashing. Built from plain gathers and masks, as the JAX version is."""
from __future__ import annotations

import torch

__all__ = ["embedding_lookup", "embedding_bag", "hash_bucket"]

# Knuth's multiplicative hash constant, split in 16-bit halves so that the
# product mod 2^32 is formed in int64 with no overflow
_HASH_MUL = 2654435761
_MASK32 = 0xFFFFFFFF


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain gather: ids (...,) -> (..., D). Negative ids return zeros."""
    emb = table[ids.clamp_min(0)]
    return emb * (ids >= 0)[..., None].to(emb.dtype)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag over fixed-width bags: ids (B, L) with -1 padding.

    mode: sum | mean | max. Returns (B, D); an empty bag gives zeros."""
    mask = ids >= 0
    emb = table[ids.clamp_min(0)]                          # (B, L, D)
    maskf = mask[..., None].to(emb.dtype)
    if mode == "sum":
        return torch.sum(emb * maskf, dim=1)
    if mode == "mean":
        cnt = torch.clamp_min(torch.sum(maskf, dim=1), 1.0)
        return torch.sum(emb * maskf, dim=1) / cnt
    if mode == "max":
        neg = torch.where(mask[..., None], emb, -torch.inf)
        out = torch.amax(neg, dim=1)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(mode)


def hash_bucket(ids: torch.Tensor, n_buckets: int,
                salt: int = 0) -> torch.Tensor:
    """Multiplicative hashing for open-vocabulary id spaces: JAX's uint32
    arithmetic (the id wrapped to uint32, plus ``salt``, times 2654435761,
    all mod 2^32, then mod ``n_buckets``), in int64. Returns int32."""
    h = (ids.to(torch.int64) + int(salt)) & _MASK32
    lo = h * (_HASH_MUL & 0xFFFF)                          # < 2^48
    hi = ((h * (_HASH_MUL >> 16)) & 0xFFFF) << 16          # its low 16 bits
    h = (lo + hi) & _MASK32
    return (h % int(n_buckets)).to(torch.int32)
