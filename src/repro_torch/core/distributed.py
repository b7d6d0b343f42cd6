"""Distributed MPAD, one process a shard of the rows (port of
``repro.core.distributed``).

Each rank holds N / P rows of the centred data. Per optimization step
each rank

  1. computes its local projections      p_loc = X_loc w
  2. all-gathers the scalars             p = all_gather(p_loc)   (4 N bytes)
  3. finds the replicated threshold and statistics (O(N log N), no
     communication: ``fast_objective``)
  4. forms its partial gradient          g_loc = X_loc^T c_loc
  5. sums it over the ranks              (4 n bytes)

so a step moves O(N + n) bytes, never the rows themselves. The ranks'
collectives are the mesh's (``repro_torch.parallel.context``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import cpu_generator
from repro_torch.parallel.context import (Mesh, all_gather, all_reduce_sum,
                                          require_mesh)

from .fast_objective import find_quantile_threshold, threshold_stats
from .mpad import MPADConfig, MPADResult, greedy_fit_loop
from .objective import num_selected_pairs, penalized

__all__ = ["fit_mpad_sharded", "make_phi_dist"]


def make_phi_dist(mesh: Mesh, n_total: int):
    """The distributed phi value-and-grad over ``mesh``: the contract of
    ``phi_fast_value_and_grad`` with ``x_loc`` this rank's block of the
    ``n_total`` rows (blocks in rank order)."""

    def phi_dist(w, x_loc, prev, prev_mask, *, b, alpha):
        k_pairs = num_selected_pairs(n_total, b)
        wn = w / torch.linalg.vector_norm(w)
        p = all_gather(mesh, x_loc @ wn, dim=0)           # (N,) replicated
        tau = find_quantile_threshold(p, k_pairs)
        st = threshold_stats(p, tau)
        cnt = st.count.clamp_min(1).to(p.dtype)
        kf = float(k_pairs)                 # may exceed the int32 range
        mu = (st.sum - (cnt - kf) * st.tau) / kf
        # this rank's slice of the coefficients -> its partial gradient
        n_loc = x_loc.shape[0]
        c_loc = st.coeff[mesh.rank * n_loc:(mesh.rank + 1) * n_loc]
        g_raw = all_reduce_sum(mesh, x_loc.T @ c_loc) / cnt
        g_mu = g_raw - torch.dot(g_raw, wn) * wn
        return penalized(mu, g_mu, w, prev, prev_mask, alpha)

    return phi_dist


def fit_mpad_sharded(x, config: MPADConfig, mesh: Optional[Mesh] = None, *,
                     w0: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> MPADResult:
    """Fit MPAD with the rows of ``x`` (N, n), given whole to every rank,
    split over the ranks of ``mesh`` (default: the context's mesh); every
    rank returns the same result. N must be a multiple of the rank count
    (pad upstream). ``w0`` (m, n) are the raw start directions (drawn from
    ``generator``, else a generator seeded with ``config.seed``, as
    ``fit_mpad`` draws them); the objective is the fast one on every
    backend, as in the JAX package, and there is no row subsampling."""
    if mesh is None:
        mesh = require_mesh("fit_mpad_sharded")
    x = torch.as_tensor(x, dtype=torch.float32).to(mesh.device)
    n_total, n_dim = x.shape
    if n_total % mesh.size:
        raise ValueError(f"N={n_total} must divide device count {mesh.size}")
    if w0 is None:
        gen = generator if generator is not None else cpu_generator(
            config.seed)
        w0 = torch.randn((config.m, n_dim), generator=gen)
    w0 = torch.as_tensor(w0, dtype=torch.float32).to(mesh.device)
    mean = x.mean(dim=0) if config.center else x.new_zeros(n_dim)
    per = n_total // mesh.size
    x_loc = (x - mean)[mesh.rank * per:(mesh.rank + 1) * per]
    matrix, traces = greedy_fit_loop(
        x_loc, w0, make_phi_dist(mesh, n_total), m=config.m, b=config.b,
        alpha=config.alpha, iters=config.iters, lr=config.lr,
        batch_size=None, beta1=config.beta1, beta2=config.beta2,
        adam_eps=config.adam_eps)
    return MPADResult(matrix=matrix, mean=mean, objective_trace=traces)
