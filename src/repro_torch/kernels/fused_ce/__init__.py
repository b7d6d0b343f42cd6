"""Fused cross-entropy (kernel K6): the wrapper that launches the CUDA
kernels (bf16 on the tensor cores, f32 on the CUDA cores;
``kernel_route``), the ``autograd.Function`` around it, its plain PyTorch
version and the materialized-logits oracle."""
from .ops import ROUTES, fused_ce, fused_ce_fwd, kernel_route, split_vocab
from .ref import ce_ref, fused_ce_fwd_plain

__all__ = ["fused_ce", "fused_ce_fwd", "fused_ce_fwd_plain", "ce_ref",
           "split_vocab", "kernel_route", "ROUTES"]
