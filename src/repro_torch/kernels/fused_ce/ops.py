"""Fused cross-entropy (kernel K6; port of ``repro.kernels.fused_ce``):
the wrapper that launches the CUDA kernel, and the ``autograd.Function``
that the JAX package's custom VJP corresponds to.

``fused_ce_fwd`` takes its plain version for tensors on the CPU, and only
for those; for CUDA tensors it launches the CUDA kernel
(``csrc/fused_ce_fwd.cu``) or raises. Each launch adds one to
``fused_ce_fwd.launches``. ``fused_ce``'s backward is the JAX ``_bwd``: an
lse pass over vocab chunks of ``gcd(4096, V)`` columns, then a pass that
forms ``dh`` and ``dw`` chunk by chunk; neither writes a (T, V) tensor. Its
products are ``torch.matmul``, as JAX leaves them to XLA outside any
kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .build import library
from .ref import fused_ce_fwd_plain

__all__ = ["fused_ce", "fused_ce_fwd", "split_vocab"]

_DTYPES = (torch.float32, torch.bfloat16)
_LABEL_DTYPES = (torch.int32, torch.int64)
_NEG_INF = -1e30
BT, BV = 64, 128          # the kernel's row tile and vocab tile
_TARGET_BLOCKS = 528      # two waves of 2 blocks on each of 132 SMs


def split_vocab(t: int, v: int) -> Tuple[int, int]:
    """(n_split, tiles_per_split): the vocab slices K6 spreads over its
    grid's second axis, so that T / 64 row tiles times the slices give the
    card about two waves of blocks."""
    row_tiles = -(-t // BT)
    n_vtiles = -(-v // BV)
    n_split = max(1, min(n_vtiles, _TARGET_BLOCKS // row_tiles))
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
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    t, d = h.shape
    v = w.shape[1]
    out = torch.empty((t,), dtype=torch.float32, device=h.device)
    if t == 0:
        return out
    n_split, per = split_vocab(t, v)
    partial = torch.empty((3, n_split, t), dtype=torch.float32,
                          device=h.device)
    labels = labels.contiguous()
    lib = library()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.qpad_fused_ce_fwd(
            h.data_ptr(), w.data_ptr(), labels.data_ptr(), out.data_ptr(),
            partial.data_ptr(), int(h.dtype == torch.bfloat16),
            int(w.dtype == torch.bfloat16), int(labels.dtype == torch.int64),
            t, d, v, v if vocab is None else int(vocab), n_split, per,
            *h.stride(), *w.stride(), stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_fwd launch failed: CUDA error {err}")
    fused_ce_fwd.launches += 1
    return out


fused_ce_fwd.launches = 0


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
