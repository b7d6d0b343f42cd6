"""Fused cross-entropy (kernel K6; port of ``repro.kernels.fused_ce``):
the wrapper that launches the CUDA kernels, and the ``autograd.Function``
that the JAX package's custom VJP corresponds to.

``fused_ce_fwd`` takes its plain version for tensors on the CPU, and only
for those; for CUDA tensors it launches a CUDA kernel or raises.
``kernel_route`` picks the kernel from the dtypes alone: bf16 h and w go
to the tensor-core kernel (``csrc/fused_ce_bf16.cu``, ``mma.sync`` with
f32 accumulators), f32 and mixed inputs to the CUDA-core kernel
(``csrc/fused_ce_fwd.cu``, f32 FMAs; TF32 products would not be exact).
Each launch adds one to ``fused_ce_fwd.launches`` and to its route's entry
of ``fused_ce_fwd.launches_by_route``. The launch itself is the custom op
``torch.ops.repro_torch.fused_ce_fwd`` (CUDA only), whose fake
implementation gives the (T,) f32 output and whose FLOP formula gives
the kernel's work, 2 * T * D * V: a trace on fake tensors counts the
launch and the FLOPs as a real call does, and builds nothing. ``fused_ce``'s backward is the JAX
``_bwd``: an lse pass over vocab chunks of ``gcd(4096, V)`` columns, then
a pass that forms ``dh`` and ``dw`` chunk by chunk; neither writes a
(T, V) tensor. Its products are ``torch.matmul``, as JAX leaves them to
XLA outside any kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch._device import CARD_DEVICE_TYPES

from .build import bf16_library, library
from .ref import fused_ce_fwd_plain

__all__ = ["fused_ce", "fused_ce_fwd", "split_vocab", "kernel_route",
           "ROUTES"]

_DTYPES = (torch.float32, torch.bfloat16)
_LABEL_DTYPES = (torch.int32, torch.int64)
_NEG_INF = -1e30
ROUTES = ("bf16", "f32")
# each route's row tile and vocab tile, and the blocks its grid aims at:
# the f32 kernel two waves of 2 blocks on each of 132 SMs, the bf16 kernel
# one wave of 1
_ROW_TILE = {"f32": 64, "bf16": 128}
_COL_TILE = {"f32": 128, "bf16": 256}
_TARGET_BLOCKS = {"f32": 528, "bf16": 132}


def kernel_route(h_dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """The kernel a CUDA call takes (one of ``ROUTES``), a function of the
    dtypes alone: bf16 h and w -> the tensor-core kernel; f32 or mixed ->
    the CUDA-core kernel."""
    for dt in (h_dtype, w_dtype):
        if dt not in _DTYPES:
            raise TypeError(f"no kernel for dtype {dt}")
    if h_dtype == w_dtype == torch.bfloat16:
        return "bf16"
    return "f32"


def split_vocab(t: int, v: int, route: str) -> Tuple[int, int]:
    """(n_split, tiles_per_split): the vocab slices K6 spreads over its
    grid's second axis, so that the row tiles times the slices give the
    card the blocks ``route``'s kernel aims at."""
    row_tiles = -(-t // _ROW_TILE[route])
    n_vtiles = -(-v // _COL_TILE[route])
    n_split = max(1, min(n_vtiles, _TARGET_BLOCKS[route] // row_tiles))
    per = -(-n_vtiles // n_split)
    return -(-n_vtiles // per), per


def _check(h, w, labels, vocab):
    if h.ndim != 2 or w.ndim != 2 or labels.ndim != 1:
        raise ValueError("h must be (T, D), w (D, V) and labels (T,)")
    if h.shape[1] != w.shape[0] or labels.shape[0] != h.shape[0]:
        raise ValueError(f"h {tuple(h.shape)}, w {tuple(w.shape)} and "
                         f"labels {tuple(labels.shape)} do not fit")
    if h.shape[1] == 0 or w.shape[1] == 0:
        raise ValueError("D and V must be at least 1")
    if not h.device == w.device == labels.device:
        raise ValueError("h, w and labels must be on one device")
    if h.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"h and w must be of {_DTYPES}, got {h.dtype}, "
                        f"{w.dtype}")
    if labels.dtype not in _LABEL_DTYPES:
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if vocab is not None and not 1 <= vocab <= w.shape[1]:
        raise ValueError(f"vocab {vocab} is not in [1, {w.shape[1]}]")


def fused_ce_fwd(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """Per-token cross-entropy: h (T, D), w (D, V), labels (T,) in
    [0, V) -> (T,) f32 ``logsumexp(h @ w) - gold``, with the columns
    >= ``vocab`` masked. h and w are f32 or bf16 (upcast to f32), in any
    strides (w may be ``embed.T``); labels int32 or int64."""
    _check(h, w, labels, vocab)
    if h.device.type == "cpu":
        return fused_ce_fwd_plain(h, w, labels, vocab)
    if h.device.type not in CARD_DEVICE_TYPES:
        raise ValueError(f"no kernel for device {h.device}")
    route = kernel_route(h.dtype, w.dtype)
    if h.shape[0] == 0:
        return torch.empty((0,), dtype=torch.float32, device=h.device)
    out = torch.ops.repro_torch.fused_ce_fwd(
        h, w, labels, w.shape[1] if vocab is None else int(vocab))
    fused_ce_fwd.launches += 1
    fused_ce_fwd.launches_by_route[route] += 1
    return out


@torch.library.custom_op("repro_torch::fused_ce_fwd", mutates_args=(),
                         device_types="cuda")
def _launch(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """One launch of K6's kernel on ``kernel_route``'s library."""
    t, d = h.shape
    v = w.shape[1]
    route = kernel_route(h.dtype, w.dtype)
    out = torch.empty((t,), dtype=torch.float32, device=h.device)
    n_split, per = split_vocab(t, v, route)
    partial = torch.empty((3, n_split, t), dtype=torch.float32,
                          device=h.device)
    labels = labels.contiguous()
    i64 = int(labels.dtype == torch.int64)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if route == "bf16":
            hb, wb, tied = _bf16_operands(h, w)
            err = bf16_library().qpad_fused_ce_bf16(
                hb.data_ptr(), wb.data_ptr(), labels.data_ptr(),
                out.data_ptr(), partial.data_ptr(), int(tied), i64, t,
                hb.shape[1], v, vocab, n_split, per, hb.stride(0),
                wb.stride(1) if tied else wb.stride(0), stream)
        else:
            err = library().qpad_fused_ce_fwd(
                h.data_ptr(), w.data_ptr(), labels.data_ptr(),
                out.data_ptr(), partial.data_ptr(),
                int(h.dtype == torch.bfloat16),
                int(w.dtype == torch.bfloat16), i64, t, d, v, vocab,
                n_split, per, *h.stride(), *w.stride(), stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_fwd ({route}) launch failed: CUDA "
                           f"error {err}")
    return out


@_launch.register_fake
def _launch_fake(h, w, labels, vocab):
    return torch.empty((h.shape[0],), dtype=torch.float32, device=h.device)


@register_flop_formula(torch.ops.repro_torch.fused_ce_fwd)
def _launch_flops(h_shape, w_shape, labels_shape, vocab, *args, **kwargs):
    return 2 * h_shape[0] * h_shape[1] * w_shape[1]


def _aligned_rows(x: torch.Tensor) -> bool:
    """Rows of 16-byte aligned, contiguous bf16 (8 elements per chunk)."""
    return (x.stride(1) == 1 and x.stride(0) % 8 == 0
            and x.data_ptr() % 16 == 0)


def _bf16_operands(h, w):
    """(h, w, tied) as the bf16 kernel reads them: h (T, Dp) and the head
    either untied, (Dp, V) with V contiguous, or tied, w.T a (V, Dp) matrix
    with D contiguous; Dp is D rounded up to 8 and every row 16-byte
    aligned. Returns the inputs themselves when they already are (the LM's
    heads are); otherwise zero-padded copies, whose extra depth adds 0 to
    every product and whose extra columns the kernel masks."""
    t, d = h.shape
    v = w.shape[1]
    dp = -(-d // 8) * 8
    if dp != d or not _aligned_rows(h):
        hp = torch.zeros((t, dp), dtype=h.dtype, device=h.device)
        hp[:, :d] = h
        h = hp
    tied = w.stride(0) == 1 and w.stride(1) != 1
    if tied:
        if dp != d or not _aligned_rows(w.T):
            wp = torch.zeros((v, dp), dtype=w.dtype, device=w.device)
            wp[:, :d] = w.T
            w = wp.T
    elif dp != d or v % 8 or not _aligned_rows(w):
        wp = torch.zeros((dp, -(-v // 8) * 8), dtype=w.dtype,
                         device=w.device)
        wp[:d, :v] = w
        w = wp
    return h, w, tied


fused_ce_fwd.launches = 0
fused_ce_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def _masked_logits(h32, wv, c0, voc):
    lg = h32 @ wv
    col = torch.arange(c0, c0 + wv.shape[1], device=h32.device)
    return torch.where(col < voc, lg, _NEG_INF), col


def _ce_backward(h, w, labels, vocab, ct, need_dh, need_dw):
    """The JAX ``_bwd``: d h = (softmax - onehot) @ w^T and
    d w = h^T @ (softmax - onehot), scaled by ``ct``, per vocab chunk
    after a first lse pass."""
    t, d = h.shape
    v = w.shape[1]
    voc = v if vocab is None else vocab
    chunk = math.gcd(4096, v)
    h32 = h.float()
    m = torch.full((t,), _NEG_INF, dtype=torch.float32, device=h.device)
    s = torch.zeros((t,), dtype=torch.float32, device=h.device)
    for c0 in range(0, v, chunk):
        lg, _ = _masked_logits(h32, w[:, c0:c0 + chunk].float(), c0, voc)
        m_n = torch.maximum(m, lg.amax(dim=1))
        s = s * torch.exp(m - m_n) + torch.exp(lg - m_n[:, None]).sum(dim=1)
        m = m_n
    lse = m + torch.log(torch.clamp_min(s, 1e-30))
    dh = (torch.zeros((t, d), dtype=torch.float32, device=h.device)
          if need_dh else None)
    dw = torch.empty((d, v), dtype=w.dtype, device=w.device) if need_dw \
        else None
    lab = labels.long()[:, None]
    ctf = ct.float()[:, None]
    for c0 in range(0, v, chunk):
        wv = w[:, c0:c0 + chunk].float()
        lg, col = _masked_logits(h32, wv, c0, voc)
        p = torch.exp(lg - lse[:, None])
        p = (p - (col[None, :] == lab).float()) * ctf
        if need_dh:
            dh.add_(p @ wv.T)
        if need_dw:
            dw[:, c0:c0 + chunk] = (h32.T @ p).to(w.dtype)
    return (dh.to(h.dtype) if need_dh else None), dw


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, vocab):
        ctx.vocab = vocab
        ctx.save_for_backward(h, w, labels)
        return fused_ce_fwd(h, w, labels, vocab)

    @staticmethod
    def backward(ctx, ct):
        h, w, labels = ctx.saved_tensors
        dh, dw = _ce_backward(h, w, labels, ctx.vocab, ct,
                              ctx.needs_input_grad[0],
                              ctx.needs_input_grad[1])
        return dh, dw, None, None


def fused_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
             vocab: Optional[int] = None) -> torch.Tensor:
    """``fused_ce_fwd`` with a gradient for h and w (labels and ``vocab``
    are not differentiable). ``dh`` comes back in h's dtype and ``dw`` in
    w's; when w is a view (``embed.T``), autograd carries ``dw`` back to
    its base."""
    return _FusedCE.apply(h, w, labels, vocab)
