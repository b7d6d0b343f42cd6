"""The tagged index union and the per-kind operation registry (port of
``repro.search.registry``): the read-only ``build`` and ``scan``, the
streaming ``stream_scan``, ``store_parts``, ``encode_delta``, ``rebuild``
and ``drift_stats``, and the sharded ``local_scan``, ``shard_payload``,
``payload_specs`` and ``stream_base_payload``.

Registered kinds: ``flat`` (exact scan of the reduced rows, kernel K3 on
the card), ``ivf`` (coarse cells, probed exact scan), ``pq``, ``opq`` (a
learned rotation, then the pq scan on the rotated query) and ``ivfpq``.

The streaming scans mask the rows a ``StreamStore`` marks dead or
unallocated before every top-k. flat, ivf, pq and opq stream in plain
torch, as the JAX package's do in plain jnp (its streaming pq scan calls
``pq_adc_scores_ref``; K2 has no masked entry). ivfpq streams on K1's
cell-major entry under ``@kernel``, the mask riding the candidate ids.

Sharded serving (``repro_torch.parallel.engine.shard_engine``) lays a
kind's payload out with ``shard_payload`` (pure padding: row-major
leaves padded to a multiple of the shard count, cell-major ones with
empty cells; ``ShardedIVF`` / ``ShardedPQ`` / ``ShardedOPQ`` /
``ShardedIVFPQ``) and splits it by ``payload_specs``, one marker a leaf
where JAX has a ``PartitionSpec``: ``ROWS`` and ``CELLS`` split dim 0
over the ranks, ``REPLICATED`` is kept whole. ``local_scan`` scans one
rank's block and returns global ids: flat on K3 over the rank's rows
(the single-device flat scan's kernel), ivf in plain torch (no kernel in
the JAX package either), pq / opq on K2's global entry, ivfpq on K1's
cell-major entry with the probes of cells owned elsewhere set to -1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.kernels.pq_adc.lut import center_lut
from repro_torch.kernels.pq_adc.ref import pq_adc_scores_ref

from .ivf import (IVFIndex, build_ivf, cell_vectors, ivf_local_scan,
                  ivf_scan, posting_lists, probe_cells, sq_dists)
from .ivfpq import (IVFPQIndex, build_ivfpq, ivfpq_adc_scan,
                    ivfpq_compact_scan, ivfpq_local_scan, ivfpq_scan)
from .knn import _sq_dists, knn_scan, knn_scan_d2, masked_topk
from .pq import (PQIndex, adc_tables, build_pq, pq_local_scan,
                 pq_reconstruct, pq_scan)
from .tracing import span

__all__ = ["Index", "IndexOps", "ScanParams", "BuildInits", "INDEX_KINDS",
           "OPQIndex", "PQQuant", "OPQQuant", "IVFPQQuant", "register_index",
           "get_ops", "encode_pq", "ivfpq_encode", "ShardedIVF", "ShardedPQ",
           "ShardedIVFPQ", "ShardedOPQ", "ROWS", "CELLS", "REPLICATED"]

# payload_specs' split markers (JAX's PartitionSpecs): ROWS / CELLS split
# dim 0 into per-rank blocks, REPLICATED keeps the leaf whole on every rank
ROWS, CELLS, REPLICATED = "rows", "cells", "replicated"

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
    lossy: bool          # scan scores approximate the metric (forces re-rank)
    build: Callable      # (reduced, spec, generator, inits) -> payload
    scan: Callable       # (state, qr, n_cand, p) -> (dists, cand)
    local_scan: Callable     # (sstate, qr, n_cand, p, shard, slack,
    #                          live=None) -> (d2, global cand)
    stream_scan: Callable    # (store, frozen, qr, n_cand, live, p) ->
    #                          (d2, internal row ids), masked by ``live``
    shard_payload: Callable  # (state, shards) -> padded sharded payload
    payload_specs: Callable  # (payload, axis) -> split marker a leaf
    store_parts: Callable    # (state, n_cap, cell_slack) -> (store field
    #                          overrides, frozen quantizer payload)
    encode_delta: Callable   # (frozen, rows) -> (assign, codes, bias)
    rebuild: Callable        # (frozen, reduced, shards) -> payload
    stream_base_payload: Callable  # (store, frozen, corpus) -> dense
    #                          payload over the store's own tensors
    #                          (shard_stream copies this rank's blocks)
    drift_stats: Optional[Callable] = None  # (frozen, rows) -> (B,) squared
    #                          reconstruction error under the frozen
    #                          quantizers (None: the kind quantizes nothing)


_REGISTRY: dict = {}


def register_index(ops: IndexOps) -> IndexOps:
    """Install (or replace) the ops entry for ``ops.kind``."""
    _REGISTRY[ops.kind] = ops
    return ops


def get_ops(kind: str) -> IndexOps:
    """Look up the registered ``IndexOps`` of an index kind (the one
    dispatch point of every build, scan and streaming site)."""
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown index kind {kind!r}; registered kinds: "
                         f"{tuple(_REGISTRY)}") from None


def _pad_rows(a: torch.Tensor, n_cap: int, fill=0) -> torch.Tensor:
    """A copy of ``a`` right-padded along dim 0 to ``n_cap`` rows."""
    pad = n_cap - a.shape[0]
    if pad <= 0:
        return a.clone()
    out = a.new_full((n_cap,) + tuple(a.shape[1:]), fill)
    out[:a.shape[0]] = a
    return out


def _pad_cells(a: torch.Tensor, slack: int, fill=0) -> torch.Tensor:
    """A copy of a cell-major array with ``slack`` more slots a cell
    (dim 1)."""
    if slack <= 0:
        return a.clone()
    out = a.new_full((a.shape[0], a.shape[1] + slack) + tuple(a.shape[2:]),
                     fill)
    out[:, :a.shape[1]] = a
    return out


def _pad_dim0(a: Optional[torch.Tensor], multiple: int, fill=0):
    """``a`` right-padded along dim 0 to a multiple of ``multiple``
    (per-shard-equal blocks); ``a`` itself when no padding is needed."""
    if a is None:
        return None
    pad = (-a.shape[0]) % multiple
    if not pad:
        return a
    out = a.new_full((a.shape[0] + pad,) + tuple(a.shape[1:]), fill)
    out[:a.shape[0]] = a
    return out


def encode_pq(codebooks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest-codeword PQ codes of rows ``x``: (B, M) int64, the argmin
    ``build_pq``'s final assignment takes (first index on ties), so a row
    codes the same at build time and at compaction."""
    m, _, dsub = codebooks.shape
    xs = x.to(torch.float32).reshape(x.shape[0], m, dsub)
    return torch.stack([sq_dists(xs[:, j], codebooks[j]).argmin(dim=1)
                        for j in range(m)], dim=1)


def _pq_decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Rows reconstructed from PQ codes: (B, M) -> (B, M * dsub) f32."""
    m, _, dsub = codebooks.shape
    ar = torch.arange(m, device=codes.device)
    return codebooks[ar[None, :], codes.long()].reshape(codes.shape[0],
                                                         m * dsub)


def ivfpq_encode(centroids: torch.Tensor, codebooks: torch.Tensor,
                 x: torch.Tensor):
    """Coarse assignment and residual PQ codes of rows ``x`` against
    frozen quantizers: (assign (B,), codes (B, M) int64, bias (B,) f32),
    the per-row payload ``build_ivfpq`` computes at build time."""
    m, _, dsub = codebooks.shape
    x = x.to(torch.float32)
    assign = sq_dists(x, centroids).argmin(dim=1)
    cent = centroids[assign]
    codes = encode_pq(codebooks, x - cent)
    ar = torch.arange(m, device=x.device)
    recon = codebooks[ar[None, :], codes]                 # (B, M, dsub)
    bias = 2.0 * (cent.reshape(x.shape[0], m, dsub) * recon).sum(dim=(1, 2))
    return assign, codes, bias


def _code_dtype(codebooks: torch.Tensor) -> torch.dtype:
    return torch.uint8 if codebooks.shape[1] <= 256 else torch.int32


def _scan_rows(store):
    """The base rows a flat or ivf stream scan reads: the reduced mirror,
    or the corpus itself when there is no Reduce stage."""
    return store.reduced if store.reduced is not None else store.corpus


def _row_ids(n: int, nq: int, device) -> torch.Tensor:
    return torch.arange(n, device=device).expand(nq, n)


class PQQuant(NamedTuple):
    """Frozen PQ quantizers (a streaming ``FrozenParams`` payload)."""
    codebooks: torch.Tensor    # (M, K, dsub)
    lut_w: torch.Tensor        # (d, M*K)
    cbnorm: torch.Tensor       # (M, K)


class OPQQuant(NamedTuple):
    """Frozen OPQ quantizers."""
    rot: torch.Tensor          # (d, d)
    codebooks: torch.Tensor    # (M, K, dsub)
    lut_w: torch.Tensor        # (d, M*K)
    cbnorm: torch.Tensor       # (M, K)


class IVFPQQuant(NamedTuple):
    """Frozen IVF-PQ quantizers."""
    centroids: torch.Tensor    # (nlist, d)
    codebooks: torch.Tensor    # (M, K, dsub)
    lut_w: torch.Tensor        # (d, M*K)
    cbnorm: torch.Tensor       # (M, K)


class OPQIndex(NamedTuple):
    """OPQ payload: a learned orthogonal rotation of the scan space plus
    plain-PQ state over the rotated rows."""
    rot: torch.Tensor          # (d, d) learned orthogonal rotation
    codebooks: torch.Tensor    # (M, K, dsub) over the rotated space
    codes: torch.Tensor        # (N, M) uint8 (int32 if K > 256)
    lut_w: torch.Tensor        # (d, M*K)
    cbnorm: torch.Tensor       # (M, K)


class ShardedIVF(NamedTuple):
    """IVF payload laid out for a mesh (cell-split)."""
    centroids: torch.Tensor    # (nlist, d) replicated
    lists: torch.Tensor        # (nlist_pad, mc) cell-split
    cell_vecs: torch.Tensor    # (nlist_pad, mc, d) cell-split mirror


class ShardedPQ(NamedTuple):
    """Plain-PQ payload laid out for a mesh (row-split)."""
    codes: torch.Tensor        # (N_pad, M) row-split, stored width
    lut_w: torch.Tensor        # (d, M*K) replicated
    cbnorm: torch.Tensor       # (M, K) replicated


class ShardedIVFPQ(NamedTuple):
    """IVF-PQ payload laid out for a mesh (cell-split)."""
    centroids: torch.Tensor    # (nlist, d) replicated
    lists: torch.Tensor        # (nlist_pad, mc) cell-split
    codes_cell: torch.Tensor   # (nlist_pad, mc, M) cell-split
    bias_cell: torch.Tensor    # (nlist_pad, mc) cell-split
    lut_w: torch.Tensor        # (d, M*K) replicated
    cbnorm: torch.Tensor       # (M, K) replicated
    codebooks: torch.Tensor    # (M, K, dsub) replicated (the LUT stats)


class ShardedOPQ(NamedTuple):
    """OPQ payload laid out for a mesh (row-split)."""
    rot: torch.Tensor          # (d, d) replicated
    codes: torch.Tensor        # (N_pad, M) row-split
    lut_w: torch.Tensor        # (d, M*K) replicated
    cbnorm: torch.Tensor       # (M, K) replicated


# --- flat: exact scan of the (reduced) vectors -------------------------------

def _flat_build(reduced, spec, generator, inits):
    # the payload is the scan rows; with no Reduce stage, the corpus itself
    return reduced


def _flat_scan(state, qr, n_cand, p):
    with span("search.scan"):
        return knn_scan(qr, state.index.payload, n_cand)


def _flat_local_scan(sstate, qr, n_cand, p, shard, slack, live=None):
    """Shard-local exact scan of this rank's row block, global ids. Rows
    past ``n_real`` are shard padding: the block is cut before them, so
    K3 (on the card) masks them as rows >= N, the single-device flat
    scan's kernel and ranking. A streaming scan (``live``) masks in plain
    torch, as the single-device streaming scan does."""
    x_loc = (sstate.index.payload if sstate.index.payload is not None
             else sstate.corpus)
    n_loc = x_loc.shape[0]
    off = shard * n_loc
    if live is not None:
        gid = off + torch.arange(n_loc, device=qr.device)
        ok = (gid < sstate.n_real) & live[gid.clamp(0, live.shape[0] - 1)]
        d2 = torch.where(ok[None, :], _sq_dists(qr, x_loc), float("inf"))
        return masked_topk(d2, gid.expand(qr.shape[0], n_loc), n_cand)
    valid = max(0, min(n_loc, sstate.n_real - off))
    d2, idx = knn_scan_d2(qr, x_loc[:valid], n_cand)
    return d2, torch.where(idx >= 0, idx + off, -1)


def _flat_stream_scan(store, frozen, qr, n_cand, live, p):
    with span("search.scan"):
        rows = _scan_rows(store)
        d2 = torch.where(live[None, :], _sq_dists(qr, rows), float("inf"))
        return masked_topk(d2, _row_ids(rows.shape[0], qr.shape[0],
                                        qr.device), n_cand)


def _flat_store_parts(state, n_cap, cell_slack):
    if state.proj is None:
        return {}, None            # the scan reads the corpus row store
    return {"reduced": _pad_rows(state.index.payload, n_cap)}, None


def _flat_shard_payload(state, shards):
    # flat with no Reduce stage scans the corpus itself: None routes the
    # local scan to the rank's corpus rows (shipped once)
    if state.index.payload is state.corpus:
        return None
    return _pad_dim0(state.index.payload, shards)


def _flat_stream_base_payload(store, frozen, corpus):
    return store.reduced if store.reduced is not None else corpus


register_index(IndexOps(
    kind="flat", lossy=False, build=_flat_build, scan=_flat_scan,
    local_scan=_flat_local_scan, stream_scan=_flat_stream_scan,
    shard_payload=_flat_shard_payload,
    payload_specs=lambda payload, axis: None if payload is None else ROWS,
    store_parts=_flat_store_parts,
    encode_delta=lambda frozen, rows: (None, None, None),
    rebuild=lambda frozen, reduced, shards: reduced,
    stream_base_payload=_flat_stream_base_payload))


# --- ivf: coarse k-means quantizer + probed exact scan -----------------------

def _ivf_build(reduced, spec, generator, inits):
    return build_ivf(reduced, spec.coarse.nlist, init=inits.coarse_init,
                     generator=generator)


def _ivf_scan(state, qr, n_cand, p):
    return ivf_scan(state.index.payload, qr, n_cand, p.nprobe)


def _ivf_local_scan(sstate, qr, n_cand, p, shard, slack, live=None):
    ix = sstate.index.payload
    return ivf_local_scan(ix.centroids, ix.lists, ix.cell_vecs, qr, n_cand,
                          p.nprobe, shard, live=live)


def _ivf_stream_scan(store, frozen, qr, n_cand, live, p):
    rows = _scan_rows(store)
    n_cap = rows.shape[0]
    with span("search.probe"):
        _, cand, _ = probe_cells(frozen.centroids, store.lists, qr,
                                 p.nprobe, n_cand)
    with span("search.scan"):
        ok = (cand >= 0) & live[cand.clamp(0, n_cap - 1)]
        cv = rows[cand.clamp_min(0)]
        d2 = ((cv - qr[:, None, :]) ** 2).sum(dim=-1)
        return masked_topk(torch.where(ok, d2, float("inf")), cand, n_cand)


def _ivf_store_parts(state, n_cap, cell_slack):
    ix = state.index.payload
    parts = {"lists": _pad_cells(ix.lists, cell_slack, fill=-1)}
    if state.proj is not None:
        parts["reduced"] = _pad_rows(ix.vectors, n_cap)
    return parts, ix.centroids


def _ivf_assign(frozen, rows):
    return sq_dists(rows.to(torch.float32), frozen.centroids).argmin(dim=1)


def _ivf_shard_payload(state, shards):
    ix = state.index.payload
    lists = _pad_dim0(ix.lists, shards, fill=-1)
    return ShardedIVF(centroids=ix.centroids, lists=lists,
                      cell_vecs=cell_vectors(lists, ix.vectors))


def _ivf_rebuild(frozen, reduced, shards):
    lists = posting_lists(_ivf_assign(frozen, reduced),
                          frozen.centroids.shape[0], shards)
    return IVFIndex(centroids=frozen.centroids, lists=lists, vectors=reduced)


def _ivf_stream_base_payload(store, frozen, corpus):
    return IVFIndex(centroids=frozen.centroids, lists=store.lists,
                    vectors=_scan_rows(store))


def _ivf_drift_stats(frozen, rows):
    return ((rows - frozen.centroids[_ivf_assign(frozen, rows)]) ** 2).sum(
        dim=-1)


register_index(IndexOps(
    kind="ivf", lossy=False, build=_ivf_build, scan=_ivf_scan,
    local_scan=_ivf_local_scan, stream_scan=_ivf_stream_scan,
    shard_payload=_ivf_shard_payload,
    payload_specs=lambda payload, axis: ShardedIVF(
        centroids=REPLICATED, lists=CELLS, cell_vecs=CELLS),
    store_parts=_ivf_store_parts,
    encode_delta=lambda frozen, rows: (_ivf_assign(frozen, rows), None,
                                       None),
    rebuild=_ivf_rebuild, stream_base_payload=_ivf_stream_base_payload,
    drift_stats=_ivf_drift_stats))


# --- pq: product-quantized vectors, shared-codes ADC scan (K2) ---------------

def _pq_build(reduced, spec, generator, inits):
    return build_pq(reduced, spec.code.subspaces, spec.code.centroids,
                    inits=inits.pq_inits, generator=generator)


def _pq_scan(state, qr, n_cand, p):
    with span("search.scan"):
        return pq_scan(state.index.payload, qr, n_cand, backend=p.backend,
                       lut_dtype=p.lut_dtype)


def _pq_local_scan(sstate, qr, n_cand, p, shard, slack, live=None):
    ix = sstate.index.payload
    return pq_local_scan(ix.lut_w, ix.cbnorm, ix.codes, qr, n_cand,
                         sstate.n_real, shard, backend=p.backend,
                         lut_dtype=p.lut_dtype, slack=slack, live=live)


def _pq_stream_scan(store, frozen, qr, n_cand, live, p):
    with span("search.scan"):
        return _pq_masked_scan(store, frozen, qr, n_cand, live, p)


def _pq_masked_scan(store, frozen, qr, n_cand, live, p):
    """The streaming pq scan: plain ADC scores over every row code, rows
    ``live`` does not mark at +inf, top-n_cand."""
    tables = adc_tables(frozen.lut_w, frozen.cbnorm, qr)
    const = (qr * qr).sum(dim=1)
    if p.lut_dtype != "f32":
        tables, offs = center_lut(tables)
        const = const + offs
    scores = (pq_adc_scores_ref(tables, store.codes, p.lut_dtype)
              + const[:, None])
    scores = torch.where(live[None, :], scores, float("inf"))
    return masked_topk(scores, _row_ids(store.codes.shape[0], qr.shape[0],
                                        qr.device), n_cand)


def _pq_store_parts(state, n_cap, cell_slack):
    # no reduced mirror: the base is scanned through its codes, the delta
    # through delta_reduced, the re-rank through the corpus
    ix = state.index.payload
    return {"codes": _pad_rows(ix.codes, n_cap)}, PQQuant(
        codebooks=ix.codebooks, lut_w=ix.lut_w, cbnorm=ix.cbnorm)


def _pq_shard_payload(state, shards):
    ix = state.index.payload
    # codes keep their stored width (uint8 for K <= 256)
    return ShardedPQ(codes=_pad_dim0(ix.codes, shards), lut_w=ix.lut_w,
                     cbnorm=ix.cbnorm)


def _pq_rebuild(frozen, reduced, shards):
    codes = encode_pq(frozen.codebooks, reduced)
    return PQIndex(codebooks=frozen.codebooks,
                   codes=codes.to(_code_dtype(frozen.codebooks)),
                   lut_w=frozen.lut_w, cbnorm=frozen.cbnorm)


def _pq_stream_base_payload(store, frozen, corpus):
    return PQIndex(codebooks=frozen.codebooks, codes=store.codes,
                   lut_w=frozen.lut_w, cbnorm=frozen.cbnorm)


def _pq_drift_stats(frozen, rows):
    codes = encode_pq(frozen.codebooks, rows)
    return ((rows - _pq_decode(frozen.codebooks, codes)) ** 2).sum(dim=-1)


register_index(IndexOps(
    kind="pq", lossy=True, build=_pq_build, scan=_pq_scan,
    local_scan=_pq_local_scan, stream_scan=_pq_stream_scan,
    shard_payload=_pq_shard_payload,
    payload_specs=lambda payload, axis: ShardedPQ(
        codes=ROWS, lut_w=REPLICATED, cbnorm=REPLICATED),
    store_parts=_pq_store_parts,
    encode_delta=lambda frozen, rows: (
        None, encode_pq(frozen.codebooks, rows), None),
    rebuild=_pq_rebuild, stream_base_payload=_pq_stream_base_payload,
    drift_stats=_pq_drift_stats))


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
    with span("search.scan"):
        return pq_scan(view, qr @ ix.rot, n_cand, backend=p.backend,
                       lut_dtype=p.lut_dtype)


def _opq_local_scan(sstate, qr, n_cand, p, shard, slack, live=None):
    ix = sstate.index.payload
    return pq_local_scan(ix.lut_w, ix.cbnorm, ix.codes, qr @ ix.rot, n_cand,
                         sstate.n_real, shard, backend=p.backend,
                         lut_dtype=p.lut_dtype, slack=slack, live=live)


def _opq_stream_scan(store, frozen, qr, n_cand, live, p):
    # rotate, then the masked pq scan serves the rotated space
    with span("search.scan"):
        return _pq_masked_scan(store, frozen, qr @ frozen.quant.payload.rot,
                               n_cand, live, p)


def _opq_store_parts(state, n_cap, cell_slack):
    ix = state.index.payload
    return {"codes": _pad_rows(ix.codes, n_cap)}, OPQQuant(
        rot=ix.rot, codebooks=ix.codebooks, lut_w=ix.lut_w, cbnorm=ix.cbnorm)


def _opq_encode(frozen, rows):
    return encode_pq(frozen.codebooks, rows @ frozen.quant.payload.rot)


def _opq_shard_payload(state, shards):
    ix = state.index.payload
    return ShardedOPQ(rot=ix.rot, codes=_pad_dim0(ix.codes, shards),
                      lut_w=ix.lut_w, cbnorm=ix.cbnorm)


def _opq_stream_base_payload(store, frozen, corpus):
    q = frozen.quant.payload
    return OPQIndex(rot=q.rot, codebooks=q.codebooks, codes=store.codes,
                    lut_w=q.lut_w, cbnorm=q.cbnorm)


def _opq_rebuild(frozen, reduced, shards):
    q = frozen.quant.payload
    return OPQIndex(rot=q.rot, codebooks=q.codebooks,
                    codes=_opq_encode(frozen, reduced).to(
                        _code_dtype(q.codebooks)),
                    lut_w=q.lut_w, cbnorm=q.cbnorm)


def _opq_drift_stats(frozen, rows):
    xr = rows @ frozen.quant.payload.rot
    codes = encode_pq(frozen.codebooks, xr)
    return ((xr - _pq_decode(frozen.codebooks, codes)) ** 2).sum(dim=-1)


register_index(IndexOps(
    kind="opq", lossy=True, build=_opq_build, scan=_opq_scan,
    local_scan=_opq_local_scan, stream_scan=_opq_stream_scan,
    shard_payload=_opq_shard_payload,
    payload_specs=lambda payload, axis: ShardedOPQ(
        rot=REPLICATED, codes=ROWS, lut_w=REPLICATED, cbnorm=REPLICATED),
    store_parts=_opq_store_parts,
    encode_delta=lambda frozen, rows: (None, _opq_encode(frozen, rows),
                                       None),
    rebuild=_opq_rebuild, stream_base_payload=_opq_stream_base_payload,
    drift_stats=_opq_drift_stats))


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


def _ivfpq_local_scan(sstate, qr, n_cand, p, shard, slack, live=None):
    ix = sstate.index.payload
    return ivfpq_local_scan(ix.centroids, ix.lists, ix.codes_cell,
                            ix.bias_cell, ix.lut_w, ix.cbnorm, ix.codebooks,
                            qr, n_cand, p.nprobe, shard, backend=p.backend,
                            lut_dtype=p.lut_dtype, live=live)


def _ivfpq_stream_scan(store, frozen, qr, n_cand, live, p):
    return ivfpq_adc_scan(frozen.centroids, store.lists, store.codes_cell,
                          store.bias_cell, frozen.lut_w, frozen.cbnorm,
                          frozen.codebooks, qr, n_cand, p.nprobe,
                          backend=p.backend, lut_dtype=p.lut_dtype, live=live)


def _ivfpq_store_parts(state, n_cap, cell_slack):
    ix = state.index.payload
    parts = {"codes": _pad_rows(ix.codes, n_cap),
             "bias": _pad_rows(ix.bias, n_cap),
             "lists": _pad_cells(ix.lists, cell_slack, fill=-1),
             "codes_cell": _pad_cells(ix.codes_cell, cell_slack),
             "bias_cell": _pad_cells(ix.bias_cell, cell_slack)}
    return parts, IVFPQQuant(centroids=ix.centroids, codebooks=ix.codebooks,
                             lut_w=ix.lut_w, cbnorm=ix.cbnorm)


def _ivfpq_shard_payload(state, shards):
    ix = state.index.payload
    return ShardedIVFPQ(
        centroids=ix.centroids, lists=_pad_dim0(ix.lists, shards, fill=-1),
        codes_cell=_pad_dim0(ix.codes_cell, shards),
        bias_cell=_pad_dim0(ix.bias_cell, shards),
        lut_w=ix.lut_w, cbnorm=ix.cbnorm, codebooks=ix.codebooks)


def _ivfpq_stream_base_payload(store, frozen, corpus):
    # rerr stays zero: the pre-filter never runs on a streaming engine
    return IVFPQIndex(
        centroids=frozen.centroids, lists=store.lists,
        codebooks=frozen.codebooks, codes=store.codes, bias=store.bias,
        rerr=torch.zeros_like(store.bias), codes_cell=store.codes_cell,
        bias_cell=store.bias_cell, lut_w=frozen.lut_w, cbnorm=frozen.cbnorm)


def _ivfpq_rebuild(frozen, reduced, shards):
    assign, codes, bias = ivfpq_encode(frozen.centroids, frozen.codebooks,
                                       reduced)
    lists = posting_lists(assign, frozen.centroids.shape[0], shards)
    lid = lists.clamp_min(0)
    code_dt = _code_dtype(frozen.codebooks)
    recon = frozen.centroids[assign] + _pq_decode(frozen.codebooks, codes)
    rerr = ((reduced - recon) ** 2).sum(dim=1).sqrt()
    return IVFPQIndex(
        centroids=frozen.centroids, lists=lists, codebooks=frozen.codebooks,
        codes=codes.to(code_dt), bias=bias, rerr=rerr,
        codes_cell=codes[lid].to(code_dt),
        bias_cell=torch.where(lists >= 0, bias[lid], 0.0),
        lut_w=frozen.lut_w, cbnorm=frozen.cbnorm)


def _ivfpq_drift_stats(frozen, rows):
    assign, codes, _ = ivfpq_encode(frozen.centroids, frozen.codebooks, rows)
    recon = frozen.centroids[assign] + _pq_decode(frozen.codebooks, codes)
    return ((rows - recon) ** 2).sum(dim=-1)


register_index(IndexOps(
    kind="ivfpq", lossy=True, build=_ivfpq_build, scan=_ivfpq_scan,
    local_scan=_ivfpq_local_scan, stream_scan=_ivfpq_stream_scan,
    shard_payload=_ivfpq_shard_payload,
    payload_specs=lambda payload, axis: ShardedIVFPQ(
        centroids=REPLICATED, lists=CELLS, codes_cell=CELLS,
        bias_cell=CELLS, lut_w=REPLICATED, cbnorm=REPLICATED,
        codebooks=REPLICATED),
    store_parts=_ivfpq_store_parts,
    encode_delta=lambda frozen, rows: ivfpq_encode(
        frozen.centroids, frozen.codebooks, rows),
    rebuild=_ivfpq_rebuild, stream_base_payload=_ivfpq_stream_base_payload,
    drift_stats=_ivfpq_drift_stats))
