"""Wrappers of kernel K3, exact L2 k-NN with top-k selection.

``knn_topk_d2`` returns squared distances, ``knn_topk`` distances (the
square root, as ``repro.kernels.knn_topk.ops.knn_topk``). Each takes the
plain PyTorch version (``ref.py``) for tensors on the CPU, and only for
those; for CUDA tensors it launches the CUDA kernel (``csrc/knn_topk.cu``)
or raises. ``knn_topk_d2.launches`` counts every launch of K3;
``knn_topk.launches`` counts those made through ``knn_topk``.

Contract (both routes): any k >= 1; (d2 or dist (Q, k) f32 ascending,
idx (Q, k) int64), ties to the lower database row (the order of
``lax.top_k``), and (+inf, -1) in the slots beyond N.
"""
from __future__ import annotations

import torch

from .build import library
from .ref import knn_ref

__all__ = ["knn_topk", "knn_topk_d2", "knn_topk_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
# the most scratch one launch may take; a call whose k-best lists would
# need more (a large k over many queries) runs its queries in chunks
_SCRATCH_CAP = 1 << 30


def knn_topk_plain(q: torch.Tensor, x: torch.Tensor, k: int):
    """K3's plain PyTorch version under the kernel's contract: ``knn_ref``
    of min(k, N), right-padded with (+inf, -1). Runs on any device; the
    wrapper takes it for CPU tensors."""
    k_eff = min(k, x.shape[0])
    d2, idx = knn_ref(q, x, k_eff)
    if k_eff < k:
        pad = k - k_eff
        d2 = torch.nn.functional.pad(d2, (0, pad), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return d2, idx


def _check(q, x, k):
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"expected q (Q, D) and x (N, D), got "
                         f"{tuple(q.shape)} and {tuple(x.shape)}")
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    if q.device != x.device:
        raise ValueError(f"inputs on different devices: {q.device}, "
                         f"{x.device}")
    if q.dtype not in _DTYPES or x.dtype != q.dtype:
        raise TypeError(f"q and x must both be float32 or both bfloat16, "
                        f"got {q.dtype} and {x.dtype}")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("q and x must be contiguous")


def _launch(lib, q, x, k, out_d, out_i):
    (nq, d), n = q.shape, x.shape[0]
    dev = q.device
    dtype = _DTYPES[q.dtype]
    nbytes = lib.qpad_knn_topk_scratch(dtype, nq, n, d, k)
    if nbytes < 0:
        raise RuntimeError("knn_topk: planning the launch failed")
    if nbytes > _SCRATCH_CAP and nq > 1:
        half = (nq + 1) // 2
        _launch(lib, q[:half], x, k, out_d[:half], out_i[:half])
        _launch(lib, q[half:], x, k, out_d[half:], out_i[half:])
        return
    norms = torch.empty(nq + n, dtype=torch.float32, device=dev)
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.qpad_knn_topk(q.data_ptr(), x.data_ptr(), dtype, nq, n, d, k,
                            norms.data_ptr(), scratch.data_ptr(), nbytes,
                            out_d.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_topk launch failed: CUDA error {err}")


def knn_topk_d2(q: torch.Tensor, x: torch.Tensor, k: int):
    """Exact k-NN by squared L2 distance (K3): q (Q, D) and x (N, D), both
    f32 or both bf16, contiguous (on either route); any k >= 1. Returns (d2 (Q, k) f32
    ascending, idx (Q, k) int64)."""
    _check(q, x, k)
    if q.device.type == "cpu":
        return knn_topk_plain(q, x, k)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    (nq, d), n = q.shape, x.shape[0]
    if max(nq, n, k) > _INT_MAX or d == 0:
        raise ValueError(f"unsupported shape: Q={nq}, N={n}, D={d}, k={k}")
    dev = q.device
    if nq == 0 or n == 0:                   # nothing to launch: all padding
        return (torch.full((nq, k), float("inf"), device=dev),
                torch.full((nq, k), -1, dtype=torch.int64, device=dev))
    if q.dtype == torch.float32:
        # the kernel stages f32 rows in 16-byte units: zero dims up to a
        # multiple of 4 (the products and squares they add are exact
        # zeros), and copy a view that does not start on 16 bytes
        q, x = (torch.nn.functional.pad(t, (0, -d % 4)) if d % 4
                else t if t.data_ptr() % 16 == 0 else t.clone()
                for t in (q, x))
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(library(), q, x, k, out_d, out_i)
    knn_topk_d2.launches += 1
    return out_d, out_i.long()


knn_topk_d2.launches = 0


def knn_topk(q: torch.Tensor, x: torch.Tensor, k: int):
    """Exact k-NN by L2 distance (K3): (dists (Q, k), idx (Q, k)), the
    square root of ``knn_topk_d2``'s distances."""
    before = knn_topk_d2.launches
    d2, idx = knn_topk_d2(q, x, k)
    knn_topk.launches += knn_topk_d2.launches - before
    return d2.clamp_min(0.0).sqrt(), idx


knn_topk.launches = 0
