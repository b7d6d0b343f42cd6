"""Causal GQA flash attention (kernel K5): the wrapper that launches the
CUDA forward kernels (bf16 on the tensor cores, f32 on the CUDA cores),
the ``autograd.Function`` around it, its plain PyTorch version, and the
full-matrix oracle the tests use."""
from .ops import ROUTES, SUPPORTED_HEAD_DIMS, flash_attention, \
    flash_attention_fwd, flash_attention_fwd_plain, kernel_route
from .ref import attention_ref

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "attention_ref", "SUPPORTED_HEAD_DIMS",
           "ROUTES", "kernel_route"]
