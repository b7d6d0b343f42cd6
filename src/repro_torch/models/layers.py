"""Shared transformer layers (port of ``repro.models.layers``): RMSNorm,
RoPE, chunked (flash-style) attention with GQA and sliding-window support,
and the SwiGLU MLP.

Attention never materialises the full (Sq x Skv) score matrix: an online
softmax runs over KV chunks (and over Q chunks when Sq is long), so the
working set is one (q_chunk x kv_chunk) tile per step. Python loops stand
in for the JAX version's ``lax.scan``s; the chunk sizes, the ragged-chunk
gcd fallback and the masking constants are the same, so the two agree to
rounding.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "chunked_attention", "swiglu", "he_init"]

_NEG_INF = -1e30


def he_init(gen: torch.Generator, shape: Sequence[int], fan_in: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal draws scaled by 1/sqrt(fan_in), made with ``gen`` on its own
    device and cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x / math.sqrt(fan_in)).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with a ``(1 + scale)`` gain, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, dh), positions: (S,) or (B, S).
    The two halves of the head rotate together (not interleaved)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions.to(torch.float32)[..., None] * freqs      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """LLaMA-style gated MLP: down(silu(x @ gate) * (x @ up))."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _attn_one_q_chunk(qc, k, v, q_pos_c, kv_pos, window, kv_chunk, scale):
    """Online softmax over KV chunks for one query chunk.

    qc: (B, Tq, KV, G, dh); k, v: (B, Skv, KV, dh); q_pos_c: (Tq,),
    kv_pos: (Skv,) with -1 marking unwritten cache slots. Returns
    (B, Tq, KV, G, dh) f32."""
    b, tq, kvh, g, dh = qc.shape
    dev = qc.device
    qf = qc.float()
    m = torch.full((b, tq, kvh, g), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, tq, kvh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, tq, kvh, g, dh), dtype=torch.float32, device=dev)
    for c0 in range(0, k.shape[1], kv_chunk):
        kc = k[:, c0:c0 + kv_chunk].float()
        vc = v[:, c0:c0 + kv_chunk].float()
        kpc = kv_pos[c0:c0 + kv_chunk]
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kc) * scale
        ok = (kpc[None, :] <= q_pos_c[:, None]) & (kpc[None, :] >= 0)
        if window is not None:
            ok &= (q_pos_c[:, None] - kpc[None, :]) < window
        s = s.masked_fill(~ok[None, :, None, None, :], _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqkgc,bckd->bqkgd", p, vc)
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                      window: Optional[int] = None, q_chunk: int = 512,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Causal GQA attention with a bounded working set.

    q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh); H = KV * G, and query head h
    reads KV head h // G. q_pos (Sq,), kv_pos (Skv,): absolute token
    positions (-1 = an unwritten cache slot). Causality (kv_pos <= q_pos)
    and the optional sliding ``window`` are enforced through positions,
    which covers prefill and decode with ring-buffer caches alike. Returns
    (B, Sq, H, dh) in q's dtype.
    """
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kvh, g, dh)
    kv_chunk = min(kv_chunk, k.shape[1])
    if k.shape[1] % kv_chunk:
        kv_chunk = math.gcd(kv_chunk, k.shape[1])
    if sq <= q_chunk:
        out = _attn_one_q_chunk(qg, k, v, q_pos, kv_pos, window, kv_chunk,
                                scale)
        return out.reshape(b, sq, h, dh).to(q.dtype)
    if sq % q_chunk:
        q_chunk = math.gcd(q_chunk, sq)
    out = torch.empty((b, sq, kvh, g, dh), dtype=q.dtype, device=q.device)
    for s0 in range(0, sq, q_chunk):
        out[:, s0:s0 + q_chunk] = _attn_one_q_chunk(
            qg[:, s0:s0 + q_chunk], k, v, q_pos[s0:s0 + q_chunk], kv_pos,
            window, kv_chunk, scale)
    return out.reshape(b, sq, h, dh)
