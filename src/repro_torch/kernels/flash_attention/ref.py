"""Full-matrix oracle of causal GQA attention (port of
``repro.kernels.flash_attention.ref``): the tests hold the chunked plain
version against it on the CPU."""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh); self-attention positions
    (q_pos = kv_pos = arange). Returns (B, Sq, H, dh) f32."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(dh)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    ok = kp <= qp
    if window is not None:
        ok &= (qp - kp) < window
    s = s.masked_fill(~ok, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, dh)
