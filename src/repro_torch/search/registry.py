"""The tagged index union and the per-kind operation registry (port of
``repro.search.registry``, with the hooks the single-device read-only
path uses: ``build`` and ``scan``).

Registered kinds: ``flat`` (exact scan of the reduced rows, kernel K3 on
the card), ``pq``, ``opq`` (a learned rotation, then the pq scan on the
rotated query) and ``ivfpq``. ``ivf`` raises with a pointer to
``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from .ivfpq import build_ivfpq, ivfpq_compact_scan, ivfpq_scan
from .knn import knn_scan
from .pq import PQIndex, build_pq, pq_reconstruct, pq_scan

__all__ = ["Index", "IndexOps", "ScanParams", "BuildInits", "INDEX_KINDS",
           "OPQIndex", "register_index", "get_ops"]

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
    and ``pq_inits`` (M, K) k-means starting rows (opq uses the same rows
    for every iterate of its build, as JAX reuses one key)."""
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


class OPQIndex(NamedTuple):
    """OPQ payload: a learned orthogonal rotation of the scan space plus
    plain-PQ state over the rotated rows."""
    rot: torch.Tensor          # (d, d) learned orthogonal rotation
    codebooks: torch.Tensor    # (M, K, dsub) over the rotated space
    codes: torch.Tensor        # (N, M) uint8 (int32 if K > 256)
    lut_w: torch.Tensor        # (d, M*K)
    cbnorm: torch.Tensor       # (M, K)


# --- flat: exact scan of the (reduced) vectors -------------------------------

def _flat_build(reduced, spec, generator, inits):
    # the payload is the scan rows; with no Reduce stage, the corpus itself
    return reduced


def _flat_scan(state, qr, n_cand, p):
    return knn_scan(qr, state.index.payload, n_cand)


register_index(IndexOps(kind="flat", lossy=False, build=_flat_build,
                        scan=_flat_scan))


# --- pq: product-quantized vectors, shared-codes ADC scan (K2) ---------------

def _pq_build(reduced, spec, generator, inits):
    return build_pq(reduced, spec.code.subspaces, spec.code.centroids,
                    inits=inits.pq_inits, generator=generator)


def _pq_scan(state, qr, n_cand, p):
    return pq_scan(state.index.payload, qr, n_cand, backend=p.backend,
                   lut_dtype=p.lut_dtype)


register_index(IndexOps(kind="pq", lossy=True, build=_pq_build,
                        scan=_pq_scan))


# --- opq: learned orthogonal rotation + PQ codes -----------------------------
# Alternate (1) k-means codebooks on the rotated rows with (2) the
# orthogonal Procrustes solution R = U V^T of X^T X_hat; the identity
# iterate is the plain-pq build (same starting rows), and the lowest-error
# iterate is kept, so opq reconstructs no worse than pq at equal code bytes.

_OPQ_ITERS = 3          # Procrustes/assignment alternations after identity


def _opq_build(reduced, spec, generator, inits):
    x = reduced.to(torch.float32)
    n, d = x.shape
    m, kc = spec.code.subspaces, spec.code.centroids
    pq_inits = inits.pq_inits
    if pq_inits is None:
        # drawn as build_pq would draw them, once for every iterate
        pq_inits = torch.stack([torch.randperm(n, generator=generator)[
            :min(kc, n)] for _ in range(m)])
    rot = torch.eye(d, dtype=torch.float32, device=x.device)
    best, best_err = None, float("inf")
    for _ in range(_OPQ_ITERS + 1):
        xr = x @ rot
        pq = build_pq(xr, m, kc, inits=pq_inits)
        recon = pq_reconstruct(pq)
        err = float(((xr - recon) ** 2).sum(dim=1).mean())
        if best is None or err < best_err:
            best, best_err = OPQIndex(rot=rot, codebooks=pq.codebooks,
                                      codes=pq.codes, lut_w=pq.lut_w,
                                      cbnorm=pq.cbnorm), err
        u, _, vt = torch.linalg.svd(x.T @ recon)
        rot = u @ vt
    return best


def _opq_scan(state, qr, n_cand, p):
    ix = state.index.payload
    view = PQIndex(codebooks=ix.codebooks, codes=ix.codes, lut_w=ix.lut_w,
                   cbnorm=ix.cbnorm)
    return pq_scan(view, qr @ ix.rot, n_cand, backend=p.backend,
                   lut_dtype=p.lut_dtype)


register_index(IndexOps(kind="opq", lossy=True, build=_opq_build,
                        scan=_opq_scan))


# --- ivfpq: coarse cells + PQ residual codes, ADC-gather scan (K1) -----------

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
