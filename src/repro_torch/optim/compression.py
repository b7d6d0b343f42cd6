"""Int8 gradient compression with error feedback (port of
``repro.optim.compression``): each gradient is quantized to int8 with one
scale per tensor, ``max|x| / 127 + 1e-12``, rounding half to even as
``jnp.round`` does, and the quantization residual is carried into the
next step."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_map

__all__ = ["compress_int8", "decompress_int8", "CompressionState",
           "init_compression_state", "ef_compress_update"]


class CompressionState(NamedTuple):
    error: Any           # tree of f32 residuals, the structure of the grads


def init_compression_state(params: Any) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, f32 scale) of x."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def ef_compress_update(grads: Any, state: CompressionState
                       ) -> Tuple[Any, CompressionState]:
    """(compressed-then-decompressed grads, new state): the returned grads
    are what the int8 collective would carry; the residual
    ``g + e - dec(q)`` is carried to the next step."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, state.error)
    dec = tree_map(lambda c: decompress_int8(*compress_int8(c)), corrected)
    return dec, CompressionState(error=tree_map(torch.sub, corrected, dec))
