"""Fused cross-entropy (kernel K6): the wrapper that launches the CUDA
kernel, the ``autograd.Function`` around it, its plain PyTorch version and
the materialized-logits oracle."""
from .ops import fused_ce, fused_ce_fwd, split_vocab
from .ref import ce_ref, fused_ce_fwd_plain

__all__ = ["fused_ce", "fused_ce_fwd", "fused_ce_fwd_plain", "ce_ref",
           "split_vocab"]
