"""MPAD trainer: greedy direction selection by Riemannian Adam on the
sphere (port of ``repro.core.mpad``, ``fast`` backend).

  for k = 1..m:
      w = start direction k, normalized
      for t = 1..T:
          phi, g = mu_b(w) - alpha * sum_j (w_j . w)^2   (tangent gradient)
          w <- normalize(w + adam(g))
      append w

The start directions are an explicit (m, n) argument (``w0``), so a test
can feed in the JAX package's ``jax.random.normal`` draws; without it they
come from a ``torch.Generator`` seeded with ``MPADConfig.seed``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch._device import DeviceLike, cpu_generator, resolve_device

from . import fast_objective

__all__ = ["MPADConfig", "MPADResult", "fit_mpad", "greedy_fit_loop",
           "transform"]


@dataclasses.dataclass(frozen=True)
class MPADConfig:
    m: int                      # target dimension (number of directions)
    b: float = 80.0             # quantile percentage in (0, 100]
    alpha: float = 25.0         # orthogonality penalty factor
    iters: int = 64             # optimization iterations per direction (T)
    lr: float = 0.05
    backend: str = "fast"       # fast | exact | kernel (only fast is ported)
    seed: int = 0
    center: bool = True
    batch_size: Optional[int] = None   # stochastic MPAD row-subsample
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8

    def __post_init__(self):
        if not (0.0 < self.b <= 100.0):
            raise ValueError(f"b must be in (0, 100], got {self.b}")
        if self.backend not in ("fast", "exact", "kernel"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.m < 1:
            raise ValueError("m must be >= 1")


class MPADResult(NamedTuple):
    matrix: torch.Tensor           # (m, n) projection matrix, rows unit-norm
    mean: torch.Tensor             # (n,) centering offset
    objective_trace: torch.Tensor  # (m, iters) phi per direction per iter

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return transform(self, x)


def transform(result: MPADResult, x: torch.Tensor) -> torch.Tensor:
    """f(x) = M (x - mean): maps (..., n) -> (..., m)."""
    return (x - result.mean) @ result.matrix.T


def _get_backend(name: str):
    if name == "fast":
        return fast_objective.phi_fast_value_and_grad
    raise NotImplementedError(
        f"MPADConfig(backend={name!r}) is not ported yet: the port has the "
        "'fast' backend only; 'exact' and 'kernel' (kernel K4) are in "
        "ROADMAP.md, 'Modules still to port', item 6 (fit path)")


def greedy_fit_loop(x: torch.Tensor, w0: torch.Tensor, phi_vg, *, m: int,
                    b: float, alpha: float, iters: int, lr: float,
                    batch_size: Optional[int], beta1: float, beta2: float,
                    adam_eps: float,
                    generator: Optional[torch.Generator] = None):
    """The greedy direction loop of Algorithm 1 over the objective backend
    ``phi_vg(w, x, prev, prev_mask, b=, alpha=)``. ``w0`` (m, n) holds the
    raw start directions; ``generator`` draws the row subsamples when
    ``batch_size`` is set. Returns (directions (m, n), phi trace (m, iters)).
    """
    n_points, n_dim = x.shape
    mbuf = x.new_zeros((m, n_dim))
    mask = x.new_zeros((m,))
    traces = x.new_zeros((m, iters))
    for k in range(m):
        w = w0[k] / torch.linalg.vector_norm(w0[k])
        mom = torch.zeros_like(w)
        vel = torch.zeros_like(w)
        for t in range(iters):
            xb = x
            if batch_size is not None and batch_size < n_points:
                rows = torch.randperm(n_points, generator=generator)
                xb = x[rows[:batch_size].to(x.device)]
            phi, g = phi_vg(w, xb, mbuf, mask, b=b, alpha=alpha)
            mom = beta1 * mom + (1.0 - beta1) * g
            vel = beta2 * vel + (1.0 - beta2) * g * g
            mhat = mom / (1.0 - beta1 ** (t + 1))
            vhat = vel / (1.0 - beta2 ** (t + 1))
            w = w + lr * mhat / (vhat.sqrt() + adam_eps)   # ascent
            w = w / torch.linalg.vector_norm(w)
            traces[k, t] = phi
        mbuf[k] = w
        mask[k] = 1.0
    return mbuf, traces


def fit_mpad(x, config: MPADConfig, *, w0: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> MPADResult:
    """Fit the MPAD projection on data ``x`` of shape (N, n).

    ``w0`` (m, n): raw start directions (normalized here, as in the JAX
    version); ``generator`` draws them (and any row subsamples) when given,
    else a generator seeded with ``config.seed`` does.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    if x.ndim != 2:
        raise ValueError(f"x must be (N, n), got {tuple(x.shape)}")
    if config.m > x.shape[1]:
        raise ValueError(f"m={config.m} exceeds input dim {x.shape[1]}")
    phi_vg = _get_backend(config.backend)
    if generator is None:
        generator = cpu_generator(config.seed)
    if w0 is None:
        w0 = torch.randn((config.m, x.shape[1]), generator=generator)
    w0 = torch.as_tensor(w0, dtype=torch.float32).to(dev)
    if tuple(w0.shape) != (config.m, x.shape[1]):
        raise ValueError(f"w0 must be ({config.m}, {x.shape[1]}), got "
                         f"{tuple(w0.shape)}")
    mean = x.mean(dim=0) if config.center else x.new_zeros(x.shape[1])
    matrix, traces = greedy_fit_loop(
        x - mean, w0, phi_vg, m=config.m, b=config.b, alpha=config.alpha,
        iters=config.iters, lr=config.lr, batch_size=config.batch_size,
        beta1=config.beta1, beta2=config.beta2, adam_eps=config.adam_eps,
        generator=generator)
    return MPADResult(matrix=matrix, mean=mean, objective_trace=traces)
