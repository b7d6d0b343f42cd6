"""Plain PyTorch version of kernel K3 (port of
``repro.kernels.knn_topk.ref``): the full L2 distance matrix and the
``lax.top_k`` selection."""
from __future__ import annotations

import torch

__all__ = ["knn_ref"]


def knn_ref(q: torch.Tensor, x: torch.Tensor, k: int):
    """Returns (d2 (Q, k) ascending squared distances, idx (Q, k) int64).

    ``d2 = max(|q|^2 + |x|^2 - 2 q.x, 0)`` in f32 (bf16 inputs are widened
    first, as the TPU kernel widens them), ties to the lower index. Runs on
    any device. Requires ``k <= N``."""
    # imported here: repro_torch.search's modules import this package
    from repro_torch.search.knn import topk_smallest
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    qq = (q * q).sum(dim=1)[:, None]
    xx = (x * x).sum(dim=1)[None, :]
    d2 = (qq + xx - 2.0 * (q @ x.T)).clamp_min(0.0)
    return topk_smallest(d2, k)
