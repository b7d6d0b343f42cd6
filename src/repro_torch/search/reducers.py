"""Pluggable Reduce stage: a ``ReducerOps`` registry (port of
``repro.search.reducers``).

A fitted projection travels as a ``Reducer`` tagged union (``kind`` +
params). Registered kinds:

* ``qpad`` — the MPAD projection (Algorithm 1), the default kind;
* ``pca``  — classical PCA (``repro_torch.core.baselines.fit_pca``), the
  same ``(matrix (m, D), mean (D,))`` params as ``qpad``;
* ``mlp``  — a linear MPAD map plus a zero-initialized tanh residual head
  trained on an exact-NN triplet margin objective over the fit sample,
  kept only when it reduces the triplet violations.

The JAX package draws the mlp fit's starting points from ``jax.random``;
the port draws them from a ``torch.Generator`` or takes them as explicit
arguments (``w0``, ``anchors``, ``negatives``, ``w1_draw``), so a test can
feed in JAX's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch._device import cpu_generator
from repro_torch.core.baselines import fit_pca
from repro_torch.core.mpad import MPADConfig, fit_mpad

__all__ = ["Reducer", "ReducerOps", "register_reducer", "get_reducer_ops",
           "fit_reducer", "reduce_vectors", "reducer_dim", "REDUCER_KINDS"]


@dataclasses.dataclass(frozen=True)
class Reducer:
    """A fitted Reduce stage: ``kind`` names the registered ops, ``params``
    holds the kind's fitted tensors."""
    kind: str
    params: Any

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Apply the fitted projection (``SearchEngine``'s
        ``state.proj(q)`` reduces a query batch)."""
        return reduce_vectors(self, x)


@dataclasses.dataclass(frozen=True)
class ReducerOps:
    """Per-kind hooks: ``fit(x, m, mpad, *, w0, generator, **draws)`` ->
    params (``mpad`` is the engine's ``MPADConfig``, read by ``qpad``
    only), ``transform(params, x)`` -> (..., m) and ``out_dim(params)`` ->
    m."""
    kind: str
    fit: Callable[..., Any]
    transform: Callable[[Any, torch.Tensor], torch.Tensor]
    out_dim: Callable[[Any], int]


_REGISTRY: dict = {}


def register_reducer(ops: ReducerOps) -> ReducerOps:
    """Register (or replace) a reducer kind."""
    _REGISTRY[ops.kind] = ops
    return ops


def get_reducer_ops(kind: str) -> ReducerOps:
    """Look up a registered reducer kind's hooks (a ``ValueError`` naming
    the registered kinds on a miss)."""
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown reducer kind {kind!r}; registered kinds: "
                         f"{tuple(_REGISTRY)}") from None


def fit_reducer(kind: str, x: torch.Tensor, m: int,
                mpad: Optional[MPADConfig] = None, *,
                w0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                **draws) -> Reducer:
    """Fit a registered reducer kind on sample ``x`` (on ``x``'s device).
    ``w0``: MPAD start directions (qpad, and mlp's linear init);
    ``generator``: the mlp fit's draws; ``draws``: explicit mlp draws."""
    return Reducer(kind, get_reducer_ops(kind).fit(
        x, m, mpad, w0=w0, generator=generator, **draws))


def reduce_vectors(proj: Optional[Reducer], x: torch.Tensor) -> torch.Tensor:
    """Apply a fitted reducer (identity when ``proj`` is None)."""
    if proj is None:
        return x
    return get_reducer_ops(proj.kind).transform(proj.params, x)


def reducer_dim(proj: Reducer) -> int:
    """The reduced dimension a fitted reducer maps into."""
    return get_reducer_ops(proj.kind).out_dim(proj.params)


# ------------------------------------------------------- linear kinds

def _affine_transform(params, x):
    matrix, mean = params
    return (x.to(torch.float32) - mean) @ matrix.T


def _affine_dim(params):
    return params[0].shape[0]


def _qpad_fit(x, m, mpad, *, w0=None, generator=None):
    del generator     # fit_mpad draws from MPADConfig.seed, as in JAX
    cfg = mpad if mpad is not None else MPADConfig(
        m=m, b=80.0, alpha=25.0, iters=48)
    if cfg.m != m:
        raise ValueError(
            f"MPADConfig.m={cfg.m} disagrees with the Reduce stage's "
            f"m={m}; the spec's reduce dim is authoritative")
    result = fit_mpad(x, cfg, w0=w0, device=x.device)
    return (result.matrix, result.mean)


def _pca_fit(x, m, mpad, *, w0=None, generator=None):
    del mpad, w0, generator            # PCA is deterministic, config-free
    return fit_pca(x, m).params


register_reducer(ReducerOps(kind="qpad", fit=_qpad_fit,
                            transform=_affine_transform,
                            out_dim=_affine_dim))
register_reducer(ReducerOps(kind="pca", fit=_pca_fit,
                            transform=_affine_transform,
                            out_dim=_affine_dim))


# ------------------------------------------ mlp (nonlinear residual)
# f(x) = (x - mean) @ lin.T + tanh((x - mean) @ w1 + b1) @ w2
# with w2 zero-initialized: the map starts exactly at the linear MPAD
# solution and the residual head trains on a triplet margin objective
# (anchor / exact-NN positive / random negative over the fit sample).

_MLP_ANCHORS = 256       # triplet anchors subsampled from the fit set
_MLP_NEGATIVES = 4       # random negatives per anchor
_MLP_STEPS = 150
_MLP_LR = 3e-3
_MLP_INIT_ITERS = 24     # MPAD iterations for the linear init
_MLP_KEYS = ("mean", "lin", "w1", "b1", "w2")


def _mlp_transform(params, x):
    xc = x.to(torch.float32) - params["mean"]
    h = torch.tanh(xc @ params["w1"] + params["b1"])
    return xc @ params["lin"].T + h @ params["w2"]


def _mlp_dim(params):
    return params["lin"].shape[0]


def _mlp_fit(x, m, mpad, *, w0=None, generator=None, anchors=None,
             negatives=None, w1_draw=None):
    """``w0`` (m, D): the linear init's MPAD start directions; ``anchors``
    (min(256, N),) distinct rows; ``negatives`` (anchors, 4) rows;
    ``w1_draw`` (D, hidden) standard normals, scaled by 1/sqrt(D) here.
    What is not given is drawn from ``generator`` (seed 0 when None), in
    that order."""
    del mpad                 # the MPAD knobs configure the qpad kind only
    x = x.to(torch.float32)
    dev = x.device
    n, d = x.shape
    gen = generator if generator is not None else cpu_generator(0)
    lin = fit_mpad(x, MPADConfig(m=m, b=80.0, alpha=25.0,
                                 iters=_MLP_INIT_ITERS),
                   w0=w0, generator=gen, device=dev)
    hidden = int(min(max(2 * m, 16), 128))
    n_anchor = min(_MLP_ANCHORS, n)
    if anchors is None:
        anchors = torch.randperm(n, generator=gen)[:n_anchor]
    if negatives is None:
        negatives = torch.randint(0, n, (n_anchor, _MLP_NEGATIVES),
                                  generator=gen)
    if w1_draw is None:
        w1_draw = torch.randn((d, hidden), generator=gen)
    anchors = torch.as_tensor(anchors, device=dev).long()
    neg = torch.as_tensor(negatives, device=dev).long()
    inv_root_d = 1.0 / torch.sqrt(torch.tensor(float(d)))
    params = {
        "mean": lin.mean,
        "lin": lin.matrix,
        "w1": torch.as_tensor(w1_draw, dtype=torch.float32, device=dev)
              * inv_root_d.to(dev),
        "b1": torch.zeros((hidden,), device=dev),
        "w2": torch.zeros((hidden, m), device=dev),
    }
    # exact-NN triplets on the fit sample: anchor a, its true nearest
    # neighbour p in the ORIGINAL space, random negatives
    xa = x[anchors]
    d2 = ((xa * xa).sum(dim=1)[:, None] + (x * x).sum(dim=1)[None, :]
          - 2.0 * xa @ x.T)
    d2[torch.arange(n_anchor, device=dev), anchors] = float("inf")
    pos = torch.argmin(d2, dim=1)
    neg_ok = (neg != anchors[:, None]) & (neg != pos[:, None])
    xp, xn = x[pos], x[neg]

    def triplet_stats(p):
        fa = _mlp_transform(p, xa)
        fp = _mlp_transform(p, xp)
        fn = _mlp_transform(p, xn.reshape(-1, d)).reshape(
            n_anchor, _MLP_NEGATIVES, m)
        dp = ((fa - fp) ** 2).sum(dim=1)
        dn = ((fa[:, None, :] - fn) ** 2).sum(dim=2)
        gap = (dp[:, None] - dn) * neg_ok          # >0 = NN order violated
        return gap, int((gap > 0).sum())

    with torch.no_grad():
        gap0, viol0 = triplet_stats(params)
        margin = 0.05 * gap0.abs().mean()
    trained = {key: params[key].clone().requires_grad_(True)
               for key in _MLP_KEYS}
    mom = {key: torch.zeros_like(params[key]) for key in _MLP_KEYS}
    vel = {key: torch.zeros_like(params[key]) for key in _MLP_KEYS}
    for t in range(_MLP_STEPS):
        with torch.enable_grad():
            gap, _ = triplet_stats(trained)
            loss = torch.relu(gap + margin).mean()
            grads = torch.autograd.grad(loss, [trained[k] for k in _MLP_KEYS])
        with torch.no_grad():
            for key, g in zip(_MLP_KEYS, grads):
                mom[key] = 0.9 * mom[key] + 0.1 * g
                vel[key] = 0.999 * vel[key] + 0.001 * g * g
                upd = ((mom[key] / (1.0 - 0.9 ** (t + 1)))
                       / ((vel[key] / (1.0 - 0.999 ** (t + 1))).sqrt()
                          + 1e-8))
                trained[key] -= _MLP_LR * upd
    trained = {key: val.detach() for key, val in trained.items()}
    # accept the residual only if it strictly improves NN-order
    # preservation on the sample; otherwise fall back to the linear init
    with torch.no_grad():
        _, viol1 = triplet_stats(trained)
    return trained if viol1 < viol0 else params


register_reducer(ReducerOps(kind="mlp", fit=_mlp_fit,
                            transform=_mlp_transform, out_dim=_mlp_dim))


REDUCER_KINDS = tuple(_REGISTRY)
