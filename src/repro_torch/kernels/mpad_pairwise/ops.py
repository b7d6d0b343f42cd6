"""Wrapper of the MPAD pairwise-statistics kernel (K4), and the MPAD
objective backed by it (port of ``repro.kernels.mpad_pairwise.ops``).

``pairwise_stats`` takes its plain version (``ref.py``) for a tensor on the
CPU, and only for that; for a CUDA tensor it launches the CUDA kernel
(``csrc/pairwise_stats.cu``) or raises. Each launch adds one to
``pairwise_stats.launches``.

The objective's schedule: the b%-quantile threshold tau_b is found on the
sorted scalar projections (O(N log N), ``fast_objective``), then one kernel
pass gives the exact count, sum and gradient coefficients.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fast_objective import find_quantile_threshold
from repro_torch.core.objective import num_selected_pairs, penalized

from .build import library
from .ref import pairwise_stats_ref

__all__ = ["pairwise_stats", "mu_kernel_value_and_grad",
           "phi_kernel_value_and_grad"]


def pairwise_stats(p: torch.Tensor, tau):
    """Threshold statistics of the scalar projections ``p`` (N,) f32 at
    ``tau`` (a scalar, or a 0-d tensor on ``p``'s device, read there
    without a host sync). Returns (count int64 scalar, sum f32 scalar,
    coeff (N,) f32)."""
    if p.ndim != 1:
        raise ValueError(f"p must be (N,), got {tuple(p.shape)}")
    tau = torch.as_tensor(tau, dtype=torch.float32, device=p.device)
    if tau.numel() != 1:
        raise ValueError("tau must be a scalar")
    if p.device.type == "cpu":
        return pairwise_stats_ref(p, tau)
    if p.device.type != "cuda":
        raise ValueError(f"no kernel for device {p.device}")
    if p.dtype != torch.float32:
        raise TypeError(f"p must be float32, got {p.dtype}")
    p = p.contiguous()
    tau = tau.reshape(1).contiguous()
    n = p.shape[0]
    dev = p.device
    coeff = torch.zeros(n, dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    s = torch.zeros((), dtype=torch.float32, device=dev)
    if n == 0:
        return count, s, coeff
    lib = library()
    with torch.cuda.device(dev):
        sizes = (ctypes.c_longlong * 2)()
        lib.qpad_pairwise_stats_scratch(n, sizes)
        coeff_part = torch.empty(sizes[0], dtype=torch.int32, device=dev)
        count_part = torch.empty(sizes[1], dtype=torch.int64, device=dev)
        sum_part = torch.empty(sizes[1], dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qpad_pairwise_stats(
            p.data_ptr(), tau.data_ptr(), n, coeff_part.data_ptr(),
            count_part.data_ptr(), sum_part.data_ptr(), coeff.data_ptr(),
            count.data_ptr(), s.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pairwise_stats launch failed: CUDA error {err}")
    pairwise_stats.launches += 1
    return count, s, coeff


pairwise_stats.launches = 0


def mu_kernel_value_and_grad(w: torch.Tensor, x: torch.Tensor, *,
                             b: float):
    """Value and tangent gradient of mu_b at unit ``w``, with the pair
    statistics from ``pairwise_stats``."""
    k_pairs = num_selected_pairs(x.shape[0], b)
    wn = w / torch.linalg.vector_norm(w)
    p = x @ wn
    tau = find_quantile_threshold(p, k_pairs)
    cnt, s, coeff = pairwise_stats(p, tau)
    cntf = cnt.clamp_min(1).to(p.dtype)
    # exact tie correction: drop the (count - k) excess pairs, all == tau
    excess = cntf - k_pairs
    value = (s - excess * tau) / k_pairs
    g_raw = (x.T @ coeff) / cntf
    g = g_raw - torch.dot(g_raw, wn) * wn      # tangent projection
    return value, g


def phi_kernel_value_and_grad(w: torch.Tensor, x: torch.Tensor,
                              prev: torch.Tensor, prev_mask: torch.Tensor, *,
                              b: float, alpha: float):
    """The trainer's backend contract (see ``repro_torch.core.mpad``):
    phi = mu_b(w) - alpha * sum_j mask_j (w_j . w)^2 and its tangent
    gradient, with mu_b from the kernel."""
    mu, g_mu = mu_kernel_value_and_grad(w, x, b=b)
    return penalized(mu, g_mu, w, prev, prev_mask, alpha)
