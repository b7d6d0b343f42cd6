"""Plain PyTorch version of the GIN aggregate (``csrc/csr_gather_sum.cu``):
JAX's ``jax.ops.segment_sum(h[edge_src] * edge_mask, edge_dst)`` as an
``index_add`` of the masked messages."""
from __future__ import annotations

import torch

__all__ = ["gather_sum_ref"]


def gather_sum_ref(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   mask: torch.Tensor, n_out: int) -> torch.Tensor:
    """out (n_out, F) with out[v] = sum of mask[e] * h[src[e]] over the
    edges e with dst[e] == v; differentiable in ``h``. On the CPU
    ``index_add`` adds the edges one after another in edge order, as JAX's
    scatter-add does there, so the bits are JAX's; the gradient (the same
    function with src and dst swapped, on the cotangent) adds in edge
    order too. Runs on any device (on a CUDA tensor ``index_add`` adds
    with atomics: only a yardstick there)."""
    msg = h[src.long()]
    msg.mul_(mask.to(h.dtype)[:, None])    # in place: one (E, F) copy
    return h.new_zeros((n_out, h.shape[1])).index_add(0, dst.long(), msg)
