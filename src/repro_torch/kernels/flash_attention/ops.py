"""Causal GQA flash attention (kernel K5; port of
``repro.kernels.flash_attention``): the wrapper that launches the forward
kernel, and the ``autograd.Function`` that the JAX package's custom VJP
corresponds to.

``flash_attention_fwd`` takes its plain version for tensors on the CPU,
and only for those; for CUDA tensors it launches a CUDA kernel or raises.
``kernel_route`` picks the kernel from the dtype alone: bf16 goes to the
tensor-core kernel (``csrc/flash_attention_bf16.cu``, ``mma.sync`` with
f32 accumulators, dh 8 zero-padded to 16 in shared memory), f32 to the
CUDA-core kernel (``csrc/flash_attention_fwd.cu``). Each launch adds one
to ``flash_attention_fwd.launches`` and to its route's entry of
``flash_attention_fwd.launches_by_route``.

The launch itself is the custom op ``torch.ops.repro_torch.
flash_attention_fwd`` (CUDA only: the stream, the library call and the
error check). Its fake implementation gives the output's shape and dtype
and its FLOP formula the kernel's work (``k5_flops``), so a trace on fake
tensors (``launch.dryrun``) passes through the wrapper, counts the launch
and the FLOPs as a real call does, and builds nothing. ``flash_attention`` runs that forward
and saves only q, k and v; its backward recomputes the attention through
the plain ``chunked_attention`` and differentiates it with
``torch.autograd.grad``, as the JAX ``_bwd`` does with ``jax.vjp`` (the
serve-fast / train-correct split: the backward is not a kernel in either
package).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch._device import CARD_DEVICE_TYPES
from repro_torch.models.layers import chunked_attention

from .build import bf16_library, library

__all__ = ["SUPPORTED_HEAD_DIMS", "ROUTES", "kernel_route",
           "flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "causal_pairs", "k5_flops"]

# one compiled instance of each kernel per head dim
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("mma_bf16", "simt_f32")


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes (one of ``ROUTES``), a function of
    dtype and head dim alone: bf16 -> the tensor-core kernel (which pads
    dh 8 to the mma's k of 16 itself), f32 -> the CUDA-core kernel."""
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {SUPPORTED_HEAD_DIMS}, "
                         f"not {head_dim}")
    if dtype == torch.bfloat16:
        return "mma_bf16"
    if dtype == torch.float32:
        return "simt_f32"
    raise TypeError(f"no kernel for dtype {dtype}")


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              window: Optional[int] = None) -> torch.Tensor:
    """The plain version: ``chunked_attention`` at self-attention
    positions (q_pos = kv_pos = arange(S))."""
    pos = torch.arange(q.shape[1], device=q.device)
    return chunked_attention(q, k, v, pos, pos, window=window)


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, S, heads, dh)")
    b, s, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[1] != s:
        raise ValueError(f"self-attention only: Sq {s} != Skv {k.shape[1]}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v must be on one device")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share a dtype of {_DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def causal_pairs(s: int, window: Optional[int] = None) -> int:
    """The (query, key) pairs causal attention over ``s`` positions scores,
    each query seeing at most ``window`` keys (itself included)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def k5_flops(b: int, s: int, h: int, dh: int,
             window: Optional[int] = None) -> int:
    """K5's work: 4 * B * H * dh FLOPs a scored pair (q k^T and p v)."""
    return 4 * b * h * dh * causal_pairs(s, window)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: the head dim contiguous, and every row
    starting on a 16-byte boundary (the kernel loads 16-byte vectors)."""
    vec = 16 // t.element_size()
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(st % vec for st in t.stride()[:3])):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int] = None) -> torch.Tensor:
    """Causal GQA self-attention with an optional sliding window.

    q: (B, S, H, dh); k, v: (B, S, KV, dh), f32 or bf16, H a multiple of
    KV, dh in ``SUPPORTED_HEAD_DIMS``. Query head h reads KV head
    h // (H // KV). Sums and softmax run in f32; returns (B, S, H, dh) in
    q's dtype. The plain version, on the CPU, takes any head dim."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, window)
    if q.device.type not in CARD_DEVICE_TYPES:
        raise ValueError(f"no kernel for device {q.device}")
    route = kernel_route(q.dtype, q.shape[3])
    if q.numel() == 0:
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    out = torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, 0 if window is None else int(window))
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[route] += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cuda")
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: int) -> torch.Tensor:
    """One launch of K5's kernel on ``kernel_route``'s library (``window``
    0: no window)."""
    b, s, h, dh = q.shape
    route = kernel_route(q.dtype, dh)
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    scale = 1.0 / math.sqrt(dh)             # rounded to f32 as JAX does
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "mma_bf16":
            err = bf16_library().qpad_flash_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, h, k.shape[2], dh, window, scale, *strides, stream)
        else:
            err = library().qpad_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, h, k.shape[2], dh, window, scale, *strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd ({route}) launch "
                           f"failed: CUDA error {err}")
    return out


@_launch.register_fake
def _launch_fake(q, k, v, window):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _launch_flops(q_shape, k_shape, v_shape, window, *args, **kwargs):
    b, s, h, dh = q_shape
    return k5_flops(b, s, h, dh, window or None)


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        return flash_attention_fwd(q, k, v, window)

    @staticmethod
    def backward(ctx, ct):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v), ctx.needs_input_grad)]
            out = flash_attention_fwd_plain(*leaves, ctx.window)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, ct))
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention_fwd`` with a gradient for q, k and v (``window``
    is not differentiable): K5 forward on the card, and a backward through
    the plain chunked path."""
    return _FlashAttention.apply(q, k, v, window)
