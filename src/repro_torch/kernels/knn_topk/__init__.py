"""Exact L2 k-NN with top-k selection (kernel K3): the wrappers that launch
the CUDA kernel and its plain PyTorch version."""
from .ops import knn_topk, knn_topk_d2, knn_topk_plain
from .ref import knn_ref

__all__ = ["knn_topk", "knn_topk_d2", "knn_topk_plain", "knn_ref"]
