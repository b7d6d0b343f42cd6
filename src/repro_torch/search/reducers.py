"""Pluggable Reduce stage: a ``ReducerOps`` registry (port of
``repro.search.reducers``, ``qpad`` kind).

A fitted projection travels as a ``Reducer`` tagged union (``kind`` +
params). The grammar knows every reducer kind of the JAX package, so one
spec string parses in both packages; only ``qpad`` is registered here so
far, and fitting ``pca`` or ``mlp`` raises until they are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.mpad import MPADConfig, fit_mpad

__all__ = ["Reducer", "ReducerOps", "register_reducer", "get_reducer_ops",
           "fit_reducer", "reduce_vectors", "REDUCER_KINDS"]

# every reducer kind of the spec grammar, ported or not
REDUCER_KINDS = ("qpad", "pca", "mlp")


@dataclasses.dataclass(frozen=True)
class Reducer:
    """A fitted Reduce stage: ``kind`` names the registered ops, ``params``
    holds the kind's fitted tensors."""
    kind: str
    params: Any


@dataclasses.dataclass(frozen=True)
class ReducerOps:
    """Per-kind hooks: ``fit(x, m, mpad, w0=...)`` -> params and
    ``transform(params, x)`` -> (..., m)."""
    kind: str
    fit: Callable[..., Any]
    transform: Callable[[Any, torch.Tensor], torch.Tensor]


_REGISTRY: dict = {}


def register_reducer(ops: ReducerOps) -> ReducerOps:
    """Register (or replace) a reducer kind."""
    _REGISTRY[ops.kind] = ops
    return ops


def get_reducer_ops(kind: str) -> ReducerOps:
    try:
        return _REGISTRY[kind]
    except KeyError:
        if kind in REDUCER_KINDS:
            raise NotImplementedError(
                f"reducer kind {kind!r} is not ported yet (see ROADMAP.md, "
                "'Modules still to port', item 6)") from None
        raise ValueError(f"unknown reducer kind {kind!r}; registered kinds: "
                         f"{tuple(_REGISTRY)}") from None


def fit_reducer(kind: str, x: torch.Tensor, m: int,
                mpad: Optional[MPADConfig] = None, *,
                w0: Optional[torch.Tensor] = None) -> Reducer:
    """Fit a registered reducer kind on sample ``x`` (on ``x``'s device)."""
    return Reducer(kind, get_reducer_ops(kind).fit(x, m, mpad, w0=w0))


def reduce_vectors(proj: Optional[Reducer], x: torch.Tensor) -> torch.Tensor:
    """Apply a fitted reducer (identity when ``proj`` is None)."""
    if proj is None:
        return x
    return get_reducer_ops(proj.kind).transform(proj.params, x)


def _affine_transform(params, x):
    matrix, mean = params
    return (x.to(torch.float32) - mean) @ matrix.T


def _qpad_fit(x, m, mpad, *, w0=None):
    cfg = mpad if mpad is not None else MPADConfig(
        m=m, b=80.0, alpha=25.0, iters=48)
    if cfg.m != m:
        raise ValueError(
            f"MPADConfig.m={cfg.m} disagrees with the Reduce stage's "
            f"m={m}; the spec's reduce dim is authoritative")
    result = fit_mpad(x, cfg, w0=w0, device=x.device)
    return (result.matrix, result.mean)


register_reducer(ReducerOps(kind="qpad", fit=_qpad_fit,
                            transform=_affine_transform))
