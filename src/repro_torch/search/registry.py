"""The tagged index union and the per-kind operation registry (port of
``repro.search.registry``, with the hooks the single-device read-only
path uses: ``build`` and ``scan``).

Only the ``ivfpq`` kind is registered so far; the other kinds of the spec
grammar raise with a pointer to ``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .ivfpq import build_ivfpq, ivfpq_compact_scan, ivfpq_scan

__all__ = ["Index", "IndexOps", "ScanParams", "BuildInits", "INDEX_KINDS",
           "register_index", "get_ops"]

# every index kind of the spec grammar, ported or not
INDEX_KINDS = ("flat", "ivf", "pq", "opq", "ivfpq")


@dataclasses.dataclass(frozen=True)
class Index:
    """The tagged union: ``kind`` + its payload of tensors."""
    kind: str
    payload: Any


@dataclasses.dataclass(frozen=True)
class ScanParams:
    """Query-time scan knobs. ``scan_cap > 0`` switches the ivfpq scan to
    the nprobe-proportional compact variant (``ivfpq_compact_scan``)."""
    nprobe: int = 8
    backend: str = "jnp"
    lut_dtype: str = "f32"
    scan_cap: int = 0


@dataclasses.dataclass(frozen=True)
class BuildInits:
    """Explicit stand-ins for the JAX package's random draws, so a test can
    build from the same starting points; ``None`` fields are drawn from the
    engine's generator. ``fit_rows`` (fit_sample,) rows of the MPAD fit
    sample; ``w0`` (m, D) MPAD start directions; ``coarse_init`` (nlist,)
    and ``pq_inits`` (M, K) k-means starting rows."""
    fit_rows: Optional[torch.Tensor] = None
    w0: Optional[torch.Tensor] = None
    coarse_init: Optional[torch.Tensor] = None
    pq_inits: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class IndexOps:
    """What the serving stack needs to know about one index kind."""
    kind: str
    lossy: bool         # scan scores approximate the metric (forces re-rank)
    build: Callable     # (reduced, spec, generator, inits) -> payload
    scan: Callable      # (state, qr, n_cand, p) -> (dists, cand)


_REGISTRY: dict = {}


def register_index(ops: IndexOps) -> IndexOps:
    """Install (or replace) the ops entry for ``ops.kind``."""
    _REGISTRY[ops.kind] = ops
    return ops


def get_ops(kind: str) -> IndexOps:
    try:
        return _REGISTRY[kind]
    except KeyError:
        if kind in INDEX_KINDS:
            raise NotImplementedError(
                f"index kind {kind!r} is not ported yet (see ROADMAP.md, "
                "'Modules still to port')") from None
        raise ValueError(f"unknown index kind {kind!r}; registered kinds: "
                         f"{tuple(_REGISTRY)}") from None


def _ivfpq_build(reduced, spec, generator, inits):
    return build_ivfpq(reduced, spec.coarse.nlist, spec.code.subspaces,
                       spec.code.centroids, device=reduced.device,
                       generator=generator, coarse_init=inits.coarse_init,
                       pq_inits=inits.pq_inits)


def _ivfpq_scan(state, qr, n_cand, p):
    ix = state.index.payload
    if p.scan_cap > 0:
        d2, ids = ivfpq_compact_scan(ix.centroids, ix.lists, ix.codes_cell,
                                     ix.bias_cell, ix.lut_w, ix.cbnorm,
                                     ix.codebooks, qr, n_cand, p.nprobe,
                                     p.scan_cap, backend=p.backend,
                                     lut_dtype=p.lut_dtype)
        return d2.clamp_min(0.0).sqrt(), ids
    return ivfpq_scan(ix, qr, n_cand, p.nprobe, backend=p.backend,
                      lut_dtype=p.lut_dtype)


register_index(IndexOps(kind="ivfpq", lossy=True, build=_ivfpq_build,
                        scan=_ivfpq_scan))
