"""Batched vector-search serving engine (port of ``repro.search.serve``:
the read-only engine, the streaming one, and sharded serving).

Pipeline: corpus -> [fit MPAD on a sample] -> reduce the corpus -> build
the index over the reduced vectors -> serve batched queries: reduce the
query -> probe/scan in the reduced space -> exact re-rank of the
candidates in the original space -> top-k.

``EngineState`` holds the re-rank corpus, the fitted projection and the
built index; ``search_fn(state, queries, k, ...)`` is the whole query
pipeline as one function of tensors. ``SearchEngine`` builds the state
once and pads each query batch to a power-of-two bucket, as the JAX engine
does, so both packages run the same scan shapes; small ivfpq buckets take
the compact scan when the posting-mass bound allows it, and (opt-in,
``prefilter_batch``, no Reduce stage) the certified re-rank pre-filter.
The index kinds served are those of ``registry`` (flat, ivf, pq, opq,
ivfpq); the Reduce stage any registered reducer kind (qpad, pca, mlp).

``SearchEngine.streaming(StreamConfig(...))`` (or ``ServeConfig(stream=
...)``) turns the built index into the frozen base of a ``StreamStore``
(``segments``) and brings ``upsert`` / ``delete`` / ``compact`` (blocking,
or on one worker thread with ``begin_compact`` / ``finish_compact``),
``vacuum``, ``rebuild_quantizers`` and the maintenance policy to life;
``search`` then runs ``stream.stream_search_fn``.

``save`` / ``repro_torch.search.load_engine`` (``snapshot``) persist and
restore an engine in the JAX package's snapshot format. ``durable(dir)``
makes a streaming engine log every write to a write-ahead log
(``durability.wal``) before it lands; ``load_engine`` recovers it after a
crash, and ``durability.replication`` keeps read-only followers of it.

``metrics()`` (``metrics``) is the engine's typed observability surface,
and ``tracing(...)`` (``tracing``) attaches latency histograms, sampled
deep traces, slow-query capture and shadow-exact recall.
``compile_count`` counts the distinct programs the engine has run, as
the JAX engine counts its jit compilations.

Sharded serving splits the database axis over the ranks of a mesh, one
process a shard (``repro_torch.parallel``): ``shard_engine`` keeps this
rank's block of corpus rows and of the kind's payload (row- or
cell-split; quantizers and projection replicated) as a
``ShardedEngineState``, and ``sharded_search_fn`` runs the pipeline on
it: the replicated probe, the shard-local scan with global ids
(``IndexOps.local_scan``), an all-gather of every rank's top-n_cand and
a global top-n_cand merge, then the re-rank in which each rank scores the
candidates it owns and a MIN all-reduce assembles the row. Every rank
returns the same result, the single-device one. ``SearchEngine.shard``
routes ``search`` there; on a streaming engine the base shards and the
delta, tombstones and id maps stay replicated (``stream``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, cpu_generator, resolve_device
from repro_torch._tree import tree_map
from repro_torch.core.mpad import MPADConfig
from repro_torch.kernels.pq_adc.lut import LUT_DTYPES, lut_error_bound
from repro_torch.parallel.context import (Mesh, all_gather, all_reduce_min,
                                          require_mesh)

from . import segments
from .durability.policy import MaintenancePolicy
from .durability.replication import ReplicationError
from .durability.wal import (RT_COMPACT, RT_DELETE, RT_POLICY, RT_UPSERT,
                             DurabilityConfig, Wal, check_ids, encode_delete,
                             encode_policy, encode_upsert)
from .ivfpq import ivfpq_lut_stats
from .knn import topk_smallest
from .pq import adc_tables
from .reducers import Reducer, fit_reducer, reduce_vectors
from .registry import (INDEX_KINDS, BuildInits, Index, ScanParams, get_ops)
from .segments import StreamConfig
from .spec import IndexSpec, parse_spec, spec_from_config
from .tracing import count, span

__all__ = ["ServeConfig", "SearchEngine", "EngineState", "ShardedEngineState",
           "search_fn", "sharded_search_fn", "exact_rerank",
           "prefiltered_rerank", "build_engine", "config_from_spec",
           "as_serve_config", "StreamConfig", "INDEX_KINDS"]

_ADC_BACKENDS = ("jnp", "kernel")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Pipeline knobs + engine knobs; the pipeline part lowers onto an
    ``IndexSpec`` (``spec_from_config``), which validates it."""
    target_dim: Optional[int] = None     # None = no reduction
    reducer: str = "qpad"                # Reduce-stage kind
    rerank: int = 64                     # candidates re-ranked in original space
    index: str = "flat"                  # one of INDEX_KINDS
    nlist: int = 64                      # ivfpq: coarse cells
    nprobe: int = 8                      # ivfpq: cells probed per query
    pq_subspaces: int = 8                # code bytes per vector
    pq_centroids: int = 256              # codebook size per subspace
    pq_backend: str = "jnp"              # ADC scoring: "jnp" (plain) | "kernel"
    lut_dtype: str = "f32"               # ADC LUT precision: f32 | bf16 | int8
    query_bucket: int = 64               # min padded query-batch size
    small_batch: int = 8                 # batches <= this take their own
    #                                      power-of-two bucket (0 disables)
    compact_batch: int = 64              # ivfpq buckets <= this take the
    #                                      compact scan when it pays (0 disables)
    prefilter_batch: int = 0             # read-only ivfpq engines with no
    #                                      Reduce stage: buckets <= this
    #                                      re-rank only the certified ADC
    #                                      survivors, same ids (0 disables)
    mpad: Optional[MPADConfig] = None    # defaults derived from target_dim
    fit_sample: int = 2048               # rows used to fit the projection
    seed: int = 0
    stream: Optional[StreamConfig] = None  # the mutable write path

    def __post_init__(self):
        if self.index not in INDEX_KINDS:
            raise ValueError(f"unknown index kind {self.index!r}; expected "
                             f"one of {INDEX_KINDS}")
        if self.pq_backend not in _ADC_BACKENDS:
            raise ValueError(f"unknown pq_backend {self.pq_backend!r}; "
                             f"expected one of {_ADC_BACKENDS}")
        if self.lut_dtype not in LUT_DTYPES:
            raise ValueError(f"unknown lut_dtype {self.lut_dtype!r}; "
                             f"expected one of {LUT_DTYPES}")
        if self.query_bucket < 1:
            raise ValueError("query_bucket must be >= 1")
        if self.small_batch < 0:
            raise ValueError("small_batch must be >= 0")
        if self.compact_batch < 0:
            raise ValueError("compact_batch must be >= 0")
        if self.prefilter_batch < 0:
            raise ValueError("prefilter_batch must be >= 0 (0 disables the "
                             "re-rank candidate pre-filter)")
        if (self.stream is not None and self.index in ("pq", "opq")
                and self.pq_backend == "kernel"):
            raise ValueError(
                f"streaming index={self.index!r} needs pq_backend='jnp': "
                "the shared-codes kernel (K2) has no masked entry point for "
                "an arbitrary tombstone bitmap (use index='ivfpq' for a "
                "kernel-backed streaming ADC scan)")
        self.to_spec()

    def to_spec(self) -> IndexSpec:
        """Lower this config onto its pipeline spec (validating)."""
        return spec_from_config(self)


def config_from_spec(spec, **runtime) -> ServeConfig:
    """Lower an ``IndexSpec`` (or spec string) onto a ``ServeConfig``;
    ``runtime`` forwards the engine knobs a spec does not carry."""
    if isinstance(spec, str):
        spec = parse_spec(spec)
    if not isinstance(spec, IndexSpec):
        raise TypeError(f"IndexSpec or spec string expected, got "
                        f"{type(spec).__name__}")
    kw = dict(index=spec.kind, rerank=spec.rerank.n)
    if spec.reduce is not None:
        kw["target_dim"] = spec.reduce.m
        kw["reducer"] = spec.reduce.kind
    if spec.coarse is not None:
        kw.update(nlist=spec.coarse.nlist, nprobe=spec.coarse.nprobe)
    if spec.code is not None:
        kw.update(pq_subspaces=spec.code.subspaces,
                  pq_centroids=spec.code.centroids,
                  lut_dtype=spec.code.lut_dtype,
                  pq_backend=spec.code.backend)
    kw.update(runtime)
    return ServeConfig(**kw)


class EngineState(NamedTuple):
    """Everything ``search_fn`` needs: the re-rank corpus, the fitted
    Reduce stage (or None) and the index as a tagged union."""
    corpus: torch.Tensor                  # (N, D) re-rank space
    proj: Optional[Reducer]               # fitted Reduce stage
    index: Index                          # kind + payload


class ShardedEngineState(NamedTuple):
    """This rank's part of an ``EngineState`` laid out for a mesh
    (``repro_torch.parallel.engine.shard_engine``): ``corpus`` its block
    of the rows (the corpus padded to a multiple of the shard count),
    ``index`` the kind and this rank's block of its sharded payload
    (``IndexOps.shard_payload``: row- or cell-split database leaves,
    replicated quantizers), ``proj`` the replicated reducer. ``n_real``
    is the unpadded row count: rows at or past it are shard padding,
    masked out of every scan."""
    corpus: torch.Tensor                  # (n_loc, D) this rank's rows
    proj: Optional[Reducer]               # replicated reducer
    n_real: int                           # the unpadded corpus size
    index: Index                          # kind + this rank's payload block


def _dedupe_candidates(cand: torch.Tensor):
    """Collapse duplicate candidate ids to -1: sort (pads sort first) +
    neighbour compare. Returns (cand sorted/deduped, valid mask)."""
    cand = torch.sort(cand, dim=1).values
    dup = torch.cat([torch.zeros_like(cand[:, :1], dtype=torch.bool),
                     cand[:, 1:] == cand[:, :-1]], dim=1)
    cand = torch.where(dup, -1, cand)
    return cand, cand >= 0


def exact_rerank(queries: torch.Tensor, corpus: torch.Tensor,
                 cand: torch.Tensor, k: int):
    """Re-score candidate ids in the original space; top-k of the
    survivors (pads and duplicates held out with +inf)."""
    cand, valid = _dedupe_candidates(cand)
    cv = corpus[torch.where(valid, cand, 0)]              # (Q, C, D)
    d2 = ((cv - queries[:, None, :]) ** 2).sum(dim=-1)
    d2 = torch.where(valid, d2, float("inf"))
    vals, sel = topk_smallest(d2, k)
    ids = torch.gather(cand, 1, sel)
    return vals.clamp_min(0.0).sqrt(), ids


def prefiltered_rerank(state: EngineState, queries: torch.Tensor,
                       qr: torch.Tensor, d_scan: torch.Tensor,
                       cand: torch.Tensor, k: int, r_s: int, lut_dtype: str,
                       counters: Optional[dict] = None):
    """Exact re-rank behind the certified candidate pre-filter (ivfpq, no
    Reduce stage, so the scan space is the re-rank space).

    From the ADC distance, the row's PQ reconstruction error ``rerr`` and
    the LUT quantization bound b (``lut_error_bound``; 0 for f32):

        LB = max(0, sqrt(max(d2 - b, 0)) - rerr) <= d
        UB = sqrt(d2 + b) + rerr                 >= d

    The k-th smallest UB is a threshold W >= d_(k); a candidate with
    LB > W cannot be a true top-k member (ties at d_(k) keep LB <= W), so
    the returned ids equal the full re-rank's. When every query's
    survivors fit ``r_s``, they are compacted left and the exact gather
    runs ``r_s`` wide (the tight branch); otherwise the full-width
    re-rank runs. The choice is one synced scalar (the JAX package's
    ``lax.cond``); ``counters``, when given, counts it under
    ``prefilter_tight`` / ``prefilter_full``.
    """
    ix = state.index.payload
    n = state.corpus.shape[0]
    valid = cand >= 0
    rerr = ix.rerr[cand.clamp(0, n - 1)]                  # (Q, C)
    if lut_dtype != "f32":
        # the grid the scan quantized onto: the raw tables for bf16, the
        # analytic centred scale for int8
        tables = adc_tables(ix.lut_w, ix.cbnorm, qr)
        scale = None
        if lut_dtype == "int8":
            _, scale = ivfpq_lut_stats(ix.codebooks, ix.cbnorm, qr,
                                       lut_dtype)
        b = lut_error_bound(tables, lut_dtype, scale)[:, None]   # (Q, 1)
    else:
        b = torch.zeros((1, 1), dtype=torch.float32, device=qr.device)
    d2 = d_scan * d_scan
    ub = (d2 + b).clamp_min(0.0).sqrt() + rerr
    lb = ((d2 - b).clamp_min(0.0).sqrt() - rerr).clamp_min(0.0)
    ub = torch.where(valid, ub, float("inf"))
    w = topk_smallest(ub, k)[0][:, -1:]                   # (Q, 1) = W
    # relative slack absorbs the sqrt / square round trips; it only keeps
    # more candidates
    keep = valid & (lb <= w + 1e-3 * (1.0 + w.abs()))
    count("host_syncs")
    tight = int(keep.sum(dim=1).max()) <= r_s
    if counters is not None:
        key = "prefilter_tight" if tight else "prefilter_full"
        counters[key] = counters.get(key, 0) + 1
    if tight:
        order = torch.argsort((~keep).to(torch.uint8), dim=1,
                              stable=True)[:, :r_s]
        cc = torch.gather(cand, 1, order)
        kk = torch.gather(keep, 1, order)
        return exact_rerank(queries, state.corpus, torch.where(kk, cc, -1),
                            k)
    return exact_rerank(queries, state.corpus, cand, k)


def _check_rerank_budget(approximate: bool, rerank: int, k: int):
    if approximate and rerank < k:
        raise ValueError(
            f"k={k} exceeds the re-rank budget rerank={rerank} on an "
            "approximate pipeline (reduction and/or PQ codes): the exact "
            "re-rank could only return rerank candidates. Raise the "
            f"Rerank stage (e.g. spec '...>rr{k}') or lower k.")


def search_fn(state: EngineState, queries: torch.Tensor, k: int, *,
              nprobe: int = 8, rerank: int = 64, backend: str = "jnp",
              lut_dtype: str = "f32", scan_cap: int = 0, prefilter: int = 0,
              counters: Optional[dict] = None):
    """The query pipeline: project -> probe/scan (dispatched on the index
    kind) -> exact re-rank -> top-k. Returns (dists (Q, k), ids (Q, k)),
    distances in the original space. ``scan_cap > 0`` (ivfpq) takes the
    compact scan; ``prefilter > 0`` (ivfpq, no Reduce stage) re-ranks only
    that many certified survivors when they fit (``prefiltered_rerank``,
    which counts its branch into ``counters`` when given). Both return the
    ids of the defaults."""
    ops = get_ops(state.index.kind)
    with span("search.project"):
        queries = queries.to(torch.float32)
        qr = reduce_vectors(state.proj, queries)
    approximate = state.proj is not None or ops.lossy
    _check_rerank_budget(approximate, rerank, k)
    n_cand = rerank if approximate else k
    p = ScanParams(nprobe=nprobe, backend=backend, lut_dtype=lut_dtype,
                   scan_cap=scan_cap)
    # the kind's scan opens search.probe / search.scan itself
    d_scan, cand = ops.scan(state, qr, n_cand, p)
    if prefilter > 0:
        if state.index.kind != "ivfpq" or state.proj is not None:
            raise ValueError(
                "prefilter needs an ivfpq index with no Reduce stage: the "
                "certified distance bounds require the scan space to be "
                "the re-rank space")
        if prefilter < n_cand:
            with span("search.rerank"):
                return prefiltered_rerank(state, queries, qr, d_scan, cand,
                                          k, prefilter, lut_dtype, counters)
    with span("search.rerank"):
        return exact_rerank(queries, state.corpus, cand, k)


# --- sharded serving (one process a shard of a database-axis mesh) ----------

def _sharded_rerank(mesh: Mesh, queries: torch.Tensor,
                    corpus_loc: torch.Tensor, cand: torch.Tensor, k: int):
    """``exact_rerank`` with the corpus split over the ranks: the same sort
    and dedupe run on every rank, each rank scores only the candidates it
    owns, and a MIN all-reduce assembles the full exact distance row
    (each candidate has one owner)."""
    cand, valid = _dedupe_candidates(cand)
    n_loc = corpus_loc.shape[0]
    local = cand - mesh.rank * n_loc
    own = valid & (local >= 0) & (local < n_loc)
    cv = corpus_loc[local.clamp(0, n_loc - 1)]
    d2 = ((cv - queries[:, None, :]) ** 2).sum(dim=-1)
    d2 = all_reduce_min(mesh, torch.where(own, d2, float("inf")))
    vals, sel = topk_smallest(d2, k)
    return vals.clamp_min(0.0).sqrt(), torch.gather(cand, 1, sel)


def _merge_local(mesh: Mesh, d2: torch.Tensor, cand: torch.Tensor,
                 n_cand: int):
    """The distributed merge: every rank's local top-n_cand gathered in
    rank order, then the global top-n_cand (ties to the lower slot, as
    ``lax.top_k``); (+inf, -1) where nothing is finite. Each rank's local
    list holds every global top-n_cand member it owns, so the merged set
    is the single-device candidate set."""
    # one collective for both: f64 holds every f32 distance and every id
    # (< 2^53) exactly
    both = all_gather(mesh, torch.stack([d2.double(), cand.double()]), dim=2)
    vals, sel = topk_smallest(both[0].float(), n_cand)
    merged = torch.gather(both[1].long(), 1, sel)
    return vals, torch.where(vals == float("inf"), -1, merged)


def _sharded_core(mesh: Mesh, sstate: ShardedEngineState,
                  queries: torch.Tensor, *, k: int, nprobe: int, rerank: int,
                  backend: str, lut_dtype: str, slack: int,
                  scan_cap: int = 0, prefilter: int = 0):
    """One rank's pipeline: project, shard-local scan, merge, re-rank."""
    if scan_cap or prefilter:
        raise ValueError(
            "scan_cap/prefilter are single-device read-only fast paths: "
            "the compact scan sizes on the unsharded posting mass and the "
            "pre-filter bounds assume the full candidate row; leave both "
            "0 on the sharded path")
    ops = get_ops(sstate.index.kind)
    queries = queries.to(torch.float32)
    qr = reduce_vectors(sstate.proj, queries)
    approximate = sstate.proj is not None or ops.lossy
    _check_rerank_budget(approximate, rerank, k)
    n_cand = rerank if approximate else k
    p = ScanParams(nprobe=nprobe, backend=backend, lut_dtype=lut_dtype)
    d2, cand = ops.local_scan(sstate, qr, n_cand, p, mesh.rank, slack)
    _, merged = _merge_local(mesh, d2, cand, n_cand)
    return _sharded_rerank(mesh, queries, sstate.corpus, merged, k)


def sharded_search_fn(sstate: ShardedEngineState, queries: torch.Tensor,
                      k: int, *, mesh: Optional[Mesh] = None,
                      axis: str = "data", nprobe: int = 8, rerank: int = 64,
                      backend: str = "jnp", lut_dtype: str = "f32",
                      scan_cap: int = 0, prefilter: int = 0):
    """``search_fn`` over the ``axis`` of ``mesh`` (default: the context's
    mesh), run by every rank on its own ``sstate`` with the same queries.

    The same contract and, by the construction of the merge, the same
    results as ``search_fn`` on the unsharded state; every rank returns
    them. K2's over-fetch ``slack`` is ``shards - 1``, the most pad rows
    a rank's block can hold.
    """
    if mesh is None:
        mesh = require_mesh("sharded_search_fn")
    _check_axis(mesh, axis)
    return _sharded_core(mesh, sstate, queries, k=k, nprobe=nprobe,
                         rerank=rerank, backend=backend, lut_dtype=lut_dtype,
                         slack=mesh.size - 1, scan_cap=scan_cap,
                         prefilter=prefilter)


def _check_axis(mesh: Mesh, axis: str):
    if axis != mesh.axis:
        raise ValueError(f"the mesh has axis {mesh.axis!r}, not {axis!r}")


def _bucket(nq: int, floor: int, small: int = 0) -> int:
    """Smallest power of two >= nq, floored at ``floor``; batches of at
    most ``small`` take their own power-of-two bucket."""
    pow2 = 1 << max(nq - 1, 0).bit_length()
    if 0 < nq <= small:
        return pow2
    return max(floor, pow2)


# the engine's programs, as the JAX engine jits them: compile_count counts
# the distinct keys each has run
_PROGRAMS = ("search", "sharded", "stream", "stream_sharded", "upsert",
             "delete", "compact")
_STREAM_PROGRAMS = _PROGRAMS[2:]


def _shapes(tree) -> tuple:
    """The shapes of every tensor leaf of ``tree``, in leaf order: the
    part of a JAX jit key that a store's grow (or a re-shard) changes."""
    from repro_torch._tree import tree_leaves
    return tuple(tuple(t.shape) for t in tree_leaves(tree)
                 if isinstance(t, torch.Tensor))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``. A copy between the host
    and the card blocks the host until it lands: a host sync."""
    t = torch.as_tensor(x, dtype=dtype)
    if t.device.type != device.type:
        count("host_syncs")
    return t.to(device)


class SearchEngine:
    """Build once over a corpus; serve batched k-NN queries.

    Runs on CUDA unless ``device`` says otherwise (and raises when no CUDA
    device is present and none was named). ``inits`` (``BuildInits``)
    replaces the engine's random draws with explicit ones; the rest come
    from a CPU ``torch.Generator`` seeded with ``config.seed``: the fit
    sample rows, then the mlp reducer's draws (for that kind), then the
    coarse k-means start, then the PQ starts.
    ``build_seconds`` records the host time of each build stage.

    With ``config.stream`` set (or after ``streaming()``) the engine
    serves a ``StreamStore``: ``state`` is released, ``store`` and
    ``frozen`` take its place, and the write methods come alive.
    ``counters`` counts compactions, swaps, vacuums, rebuilds, policy
    grows and the pre-filter's branches (``prefilter_tight`` /
    ``prefilter_full``); ``grow_count`` the stores grown by a compaction
    overflow. ``durable(dir)`` logs every write before it lands;
    ``crash_hook`` (a callable of a point name) fires at the JAX
    package's lifecycle points: ``wal_appended``, ``compact_begin``,
    ``compact_task``, ``compact_swap``, ``compact_done``,
    ``snapshot_arrays``, ``snapshot_commit``, ``vacuum``, ``rebuild``.

    ``compile_count`` is the number of distinct programs the engine has
    run, keyed as the JAX engine's jit caches are: the read-only search
    by (k, bucket, the normalized knobs), the streaming search by the same
    and the store's shapes, upsert and delete by the write bucket and the
    store's shapes, compaction by the store's shapes. Streaming programs
    start afresh at ``streaming()`` and at a quantizer rebuild, as JAX
    re-jits them there. ``metrics()`` returns the typed ``EngineMetrics``;
    ``tracing(...)`` attaches a ``Tracer``. ``shard(mesh)`` splits the
    engine over a serving mesh (``sharded_state``; a streaming engine's
    base); its programs key on the mesh's axis and size as well.
    """

    def __init__(self, corpus, config=ServeConfig(), *,
                 device: DeviceLike = None,
                 inits: Optional[BuildInits] = None):
        config = as_serve_config(config)
        spec = config.to_spec()
        self.device = resolve_device(device)
        inits = inits if inits is not None else BuildInits()
        corpus_in = corpus
        corpus = torch.as_tensor(corpus, dtype=torch.float32).to(self.device)
        n = corpus.shape[0]
        gen = cpu_generator(config.seed)
        times = {}
        t0 = time.perf_counter()
        if spec.reduce is not None:
            mcfg = config.mpad
            if mcfg is None and spec.reduce.kind == "qpad":
                mcfg = MPADConfig(m=spec.reduce.m, b=80.0, alpha=25.0,
                                  iters=48, seed=config.seed)
            rows = inits.fit_rows
            if rows is None and config.fit_sample < n:
                rows = torch.randperm(n, generator=gen)[:config.fit_sample]
            sample = corpus if rows is None else corpus[
                torch.as_tensor(rows, dtype=torch.int64).to(self.device)]
            proj = fit_reducer(spec.reduce.kind, sample, spec.reduce.m, mcfg,
                               w0=inits.w0, generator=gen)
            _sync(self.device)
            times["fit"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            reduced = reduce_vectors(proj, corpus)
            _sync(self.device)
            times["reduce"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        else:
            proj, reduced = None, corpus
        payload = get_ops(config.index).build(reduced, spec, gen, inits)
        _sync(self.device)
        times["index"] = time.perf_counter() - t0
        self.build_seconds = times
        self._attach(config, EngineState(corpus=corpus, proj=proj,
                                         index=Index(config.index, payload)))
        # a caller's tensor that passes through unconverted stays the
        # caller's: shard(donate=True) must not free it
        self._user_corpus = corpus if corpus is corpus_in else None

    @classmethod
    def from_state(cls, state: EngineState, config) -> "SearchEngine":
        """An engine around already-built tensors (e.g. a state carried
        across from the JAX package by ``repro_torch.bridge``); a config
        with ``stream`` set makes it streaming over a copy of them."""
        eng = object.__new__(cls)
        eng.device = state.corpus.device
        eng.build_seconds = {}
        eng._attach(as_serve_config(config), state)
        return eng

    @classmethod
    def from_store(cls, store: "segments.StreamStore",
                   frozen: "segments.FrozenParams",
                   config) -> "SearchEngine":
        """A streaming engine around an existing store and its frozen
        quantizers (``bridge.stream_from_arrays`` carries JAX's across);
        ``config.stream`` must be set."""
        config = as_serve_config(config)
        if config.stream is None:
            raise ValueError("from_store needs a config with stream set")
        eng = object.__new__(cls)
        eng.device = store.corpus.device
        eng.build_seconds = {}
        eng._attach(config, None, store=store, frozen=frozen)
        return eng

    @classmethod
    def _restore(cls, config, *, state=None, store=None,
                 frozen=None) -> "SearchEngine":
        """An engine around restored tensors (``snapshot.load_engine``):
        no fit, no index build. Exactly one of ``state`` (read-only) or
        ``store`` + ``frozen`` (streaming) is given."""
        if state is not None:
            return cls.from_state(state, config)
        return cls.from_store(store, frozen, config)

    @property
    def reducer(self) -> Optional[Reducer]:
        """The fitted Reduce stage (None without one): the read-only
        state's, a streaming engine's frozen one, or (after
        ``shard(donate=True)``) the sharded state's replicated one."""
        for holder in (self.state, self.frozen, self.sharded_state):
            if holder is not None:
                return holder.proj
        return None

    @property
    def spec(self) -> IndexSpec:
        """The pipeline spec this engine serves (lowered from the current
        config)."""
        return self.config.to_spec()

    def save(self, directory: str, incremental: bool = False) -> str:
        """Snapshot the engine (spec, config and tensors) into
        ``directory`` in the JAX package's format; restore it with
        ``repro_torch.search.load_engine`` (or the JAX package's). A
        streaming engine saves its delta and tombstones as they are, so a
        mid-delta snapshot restores mid-delta. ``incremental=True`` (a
        durable streaming engine, into its own directory, after a full
        save and before the base changes) saves only the delta, the
        tombstones, the id maps and the WAL position, chained to the
        newest full snapshot. Returns the checkpoint path."""
        from .snapshot import save_engine
        return save_engine(self, directory, incremental=incremental)

    def _attach(self, config: ServeConfig, state, store=None, frozen=None):
        self.config = config
        self.state = state
        self._user_corpus = None
        # sharded serving (shard()): this rank's part of the state, the
        # mesh, and a streaming engine's sharded base
        self.sharded_state: Optional[ShardedEngineState] = None
        self._mesh: Optional[Mesh] = None
        self._shard_axis = "data"
        self._stream_sharded_base: Optional[ShardedEngineState] = None
        self.last_bucket: Optional[int] = None
        self._scan_caps: dict = {}   # nprobe -> compact-scan gather width
        self._programs = {name: set() for name in _PROGRAMS}
        # observability (tracing): None until tracing(); the serve path
        # takes no timestamp and no sync without an active tracer
        self._tracer = None
        self._deep_warm: set = set()  # deep-trace keys already run once
        self.store, self.frozen = store, frozen
        self.grow_count = 0          # stores grown by compaction overflow
        self._delta_used = 0         # host mirror of the delta fill
        #                              (overwrites counted as appends)
        # durability (durability.wal / recovery): all inert until durable()
        self.crash_hook = None       # callable(point name) at the lifecycle
        #                              points (crash drills; a hook that
        #                              blocks schedules a background fold)
        self._replaying = False      # WAL replay in flight: appends, the
        #                              pre-write auto-compaction and policy
        #                              decisions are off
        self._wal: Optional[Wal] = None
        self._durability: Optional[DurabilityConfig] = None
        self._durable_dir: Optional[str] = None   # snapshot + wal directory
        self._replayed = 0           # records applied by recovery
        # replication (durability.replication)
        self._role = "primary"       # "follower": tails a shipped WAL and
        #                              refuses local writes
        self._applied_seq = -1       # last WAL seq reflected in the store
        self._repl_catch_ups = 0     # catch_up passes completed
        self._repl_records = 0       # shipped records applied
        self._repl_source_tail = -1  # source tail at the last catch_up
        self._repl_last_catch_up_ts = None   # wall clock of the last pass
        self._repl_caught_up_ts = None       # ... of the last that drained
        # incremental snapshots (snapshot.py)
        self._base_ref = None        # {dir, ckpt, wal_seq, chain} of the
        #                              newest full snapshot and its links
        self._base_dirty = False     # base tensors rewritten since it
        #                              (compact / vacuum / rebuild / grow):
        #                              the next save must be full
        self._snap_counters = {"full": 0, "incremental": 0,
                               "last_bytes": 0, "chain_depth": 0}
        self._policy: Optional[MaintenancePolicy] = None
        self._policy_active = False  # decisions only when the user
        #                              configured StreamConfig.policy
        self._compact_future = None  # pending background compaction
        self._compact_executor: Optional[ThreadPoolExecutor] = None
        self._compact_tail: list = []    # writes made during the fold,
        self._tail_rows = 0              # re-applied at the swap
        self.counters = {"compactions": 0, "swaps": 0, "vacuums": 0,
                         "rebuilds": 0, "policy_grows": 0,
                         "prefilter_tight": 0, "prefilter_full": 0}
        if store is not None:
            self._delta_used = int(store.delta_count)
            self._stream_policy_init()
        elif config.stream is not None:
            self._init_stream()

    @property
    def compile_count(self) -> int:
        """Number of distinct program keys this engine has run: the JAX
        engine's compiled (statics, shapes) variants of its read-only
        search, streaming search, upsert, delete and compact programs."""
        return sum(len(keys) for keys in self._programs.values())

    def _reset_stream_programs(self):
        """Fresh streaming programs (``streaming()``, a quantizer rebuild):
        the JAX engine re-jits them there, emptying their caches."""
        for name in _STREAM_PROGRAMS:
            self._programs[name] = set()

    def _upsert(self, store, ids, vectors):
        self._programs["upsert"].add((tuple(ids.shape), _shapes(store)))
        return segments.upsert_fn(store, self.frozen, ids, vectors)

    def _delete(self, store, ids):
        self._programs["delete"].add((tuple(ids.shape), _shapes(store)))
        return segments.delete_fn(store, ids)

    def _compact(self, store):
        self._programs["compact"].add(_shapes(store))
        return segments.compact_fn(store, self.frozen)

    def _scan_cap(self, nprobe: int) -> int:
        """Compact-scan gather width at ``nprobe``: the sum of the
        ``nprobe`` largest cell fills rounded up to 128, so the compact
        scan never truncates a query's candidates. 0 (off) unless it cuts
        well over a third of the padded ``nprobe * max_cell`` slots.
        Host-side and cached per nprobe."""
        cap = self._scan_caps.get(nprobe)
        if cap is None:
            lists = self.state.index.payload.lists
            count("host_syncs")
            lens = (lists >= 0).sum(dim=1).cpu().numpy()
            top = np.sort(lens)[-nprobe:]
            cap = -(-int(top.sum()) // 128) * 128
            if cap * 8 >= nprobe * lists.shape[1] * 5:
                cap = 0
            self._scan_caps[nprobe] = cap
        return cap

    def search(self, queries, k: int):
        """Returns (dists (Q, k), ids (Q, k)) on the engine's device. The
        batch is zero-padded to its power-of-two bucket, then sliced back.
        A streaming engine returns external ids and first swaps in a
        background compaction that has finished."""
        with span("search", self.device):
            cfg = self.config
            ops = get_ops(cfg.index)
            _check_rerank_budget(cfg.target_dim is not None or ops.lossy,
                                 cfg.rerank, k)
            queries = _on_device(queries, torch.float32, self.device)
            nq = queries.shape[0]
            bucket = _bucket(nq, cfg.query_bucket, cfg.small_batch)
            self.last_bucket = bucket
            if bucket != nq:
                queries = torch.nn.functional.pad(queries,
                                                  (0, 0, 0, bucket - nq))
            # knobs the index kind cannot observe are normalized, as the
            # JAX engine does, so flipping one never makes a new program
            probed = cfg.index in ("ivf", "ivfpq")
            coded = cfg.index in ("pq", "opq", "ivfpq")
            kw = dict(nprobe=cfg.nprobe if probed else 0, rerank=cfg.rerank,
                      backend=cfg.pq_backend if coded else "jnp",
                      lut_dtype=cfg.lut_dtype if coded else "f32",
                      scan_cap=0, prefilter=0)
            if (self.store is None and self.sharded_state is None
                    and cfg.index == "ivfpq"):
                if 0 < bucket <= cfg.compact_batch:
                    kw["scan_cap"] = self._scan_cap(cfg.nprobe)
                if (0 < bucket <= cfg.prefilter_batch
                        and cfg.target_dim is None):
                    r_s = max(2 * k, cfg.rerank // 2)
                    if r_s < cfg.rerank:
                        kw["prefilter"] = r_s
            # tracing: one perf_counter read when a tracer is attached and
            # active; with none the serve path is exactly the untraced one
            tracer = self._tracer
            t0 = (time.perf_counter()
                  if tracer is not None and tracer.active else None)
            key = (k, bucket) + tuple(kw.values())
            if self.store is not None:
                from .stream import (replica_from_store,
                                     sharded_stream_search_fn,
                                     stream_search_fn)
                self._poll_compaction()
                sbase = self._stream_sharded_base
                if sbase is not None:
                    repl = replica_from_store(self.store)
                    self._programs["stream_sharded"].add(
                        key + self._mesh_key() + _shapes(
                            (sbase.corpus, sbase.index.payload, repl)))
                    d, ids = sharded_stream_search_fn(
                        sbase, repl, queries, k, mesh=self._mesh,
                        axis=self._shard_axis, **kw)
                else:
                    self._programs["stream"].add(
                        key + (_shapes(self.store),))
                    d, ids = stream_search_fn(self.store, self.frozen,
                                              queries, k, **kw)
            elif self.sharded_state is not None:
                self._programs["sharded"].add(key + self._mesh_key())
                d, ids = sharded_search_fn(self.sharded_state, queries, k,
                                           mesh=self._mesh,
                                           axis=self._shard_axis, **kw)
            else:
                self._programs["search"].add(key)
                d, ids = search_fn(self.state, queries, k,
                                   counters=self.counters, **kw)
        if t0 is not None:
            # synchronizes (an honest end-to-end time), then records and
            # samples
            tracer.on_search(self, queries, nq, k, kw, t0, d, ids)
        return d[:nq], ids[:nq]

    # --- sharding ---------------------------------------------------------

    def _mesh_key(self) -> tuple:
        """The part of a sharded program's key the mesh gives (JAX's jit
        caches key on the mesh and the axis)."""
        return (self._mesh.axis, self._mesh.size)

    def _shard_stream_base(self):
        from repro_torch.parallel.engine import shard_stream
        self._stream_sharded_base = shard_stream(
            self.store, self.frozen, self._mesh, axis=self._shard_axis)

    def shard(self, mesh: Optional[Mesh] = None, axis: str = "data",
              donate: bool = False) -> "SearchEngine":
        """Partition the engine over the ``axis`` of ``mesh`` (default: the
        mesh of ``repro_torch.parallel.context.mesh_context``); every rank
        of the mesh calls it on its own engine, built or restored alike.

        Later ``search`` calls (made by every rank with the same queries)
        run ``sharded_search_fn``: the same results, the database split
        over the ranks. Returns ``self``. Re-call with another mesh to
        re-shard.

        ``donate=True`` frees the dense state once this rank's block is
        taken (no second copy of the database): its tensors are emptied
        (``Tensor.set_()``), except a corpus tensor the caller handed in;
        re-sharding then raises. On a streaming engine the **base** shards
        and the delta, tombstones and id maps stay replicated (writes keep
        working; ``compact()`` re-lays the base out); donation is refused
        there, since the dense store is the write path.
        """
        if mesh is None:
            mesh = require_mesh("SearchEngine.shard()")
        _check_axis(mesh, axis)
        self._mesh, self._shard_axis = mesh, axis
        if self.store is not None:
            if donate:
                raise ValueError(
                    "donate=True is not supported on a streaming engine: "
                    "the dense StreamStore backs upsert/delete/compact")
            if self._compact_future is not None:
                self.finish_compact()    # lay out the post-fold base, once
            self._shard_stream_base()
            return self
        if self.state is None:
            raise RuntimeError(
                "the dense EngineState is gone: its tensors were freed by "
                "shard(donate=True); rebuild the engine (or load_engine "
                "from a snapshot) to re-shard")
        from repro_torch.parallel.engine import shard_engine
        keep = (self._user_corpus,) if self._user_corpus is not None else ()
        self.sharded_state = shard_engine(self.state, mesh, axis=axis,
                                          donate=donate, keep=keep)
        if donate:
            self.state = None
        return self

    # --- streaming (mutable) serving -------------------------------------

    def streaming(self, config: Optional[StreamConfig] = None
                  ) -> "SearchEngine":
        """Enable the write path on a built engine: the index becomes the
        frozen base of a ``StreamStore`` with a delta segment and
        tombstones, and the dense state is released. Call once, after the
        build and before ``shard``. Returns ``self``."""
        if self.store is not None:
            raise RuntimeError("this engine is already streaming; "
                               "re-configure by rebuilding it")
        if self.sharded_state is not None:
            raise RuntimeError(
                "enable streaming BEFORE shard(): the store takes over the "
                "dense tensors, which would leave the sharded state stale; "
                "rebuild, call streaming(...), then shard(mesh)")
        if self.state is None:
            raise RuntimeError(
                "the dense EngineState is gone (shard(donate=True)); "
                "streaming needs the dense tensors: rebuild the engine or "
                "load_engine from a snapshot")
        # replace() re-runs the config's validation (pq + kernel refused)
        self.config = dataclasses.replace(
            self.config, stream=config or StreamConfig())
        self._init_stream()
        return self

    def _require_stream(self):
        if self.store is None:
            raise RuntimeError(
                "this engine is read-only; enable the write path with "
                "engine.streaming(StreamConfig(...)) or "
                "ServeConfig(stream=StreamConfig(...))")
        if self._role == "follower" and not self._replaying:
            raise ReplicationError(
                "this engine is a follower: its store is a replica of a "
                "primary's WAL and local writes would fork the history. "
                "Write to the primary and catch_up, or re-open the "
                "snapshot without role='follower' to promote it.")

    def _init_stream(self):
        self.store, self.frozen = segments.make_mutable(self.state,
                                                        self.config.stream)
        # the store holds fresh copies of every database tensor and the
        # frozen params alias the quantizers: the state is a duplicate
        self.state = None
        self._scan_caps = {}
        self._reset_stream_programs()
        self._stream_policy_init()

    def _stream_policy_init(self):
        """The policy, and (when the user configured one) its drift
        baseline: the mean encode error of up to 1024 base rows."""
        scfg = self.config.stream
        self._policy = MaintenancePolicy(scfg.policy)
        self._policy_active = scfg.policy is not None
        if not self._policy_active:
            return
        ops = get_ops(self.config.index)
        n = int(self.store.n_rows)
        if ops.drift_stats is None or n == 0:
            return
        rows = reduce_vectors(self.frozen.proj,
                              self.store.corpus[:min(n, 1024)])
        self._policy.observe_build_error(
            float(ops.drift_stats(self.frozen, rows).mean()))

    def _crash(self, point: str):
        if self.crash_hook is not None:
            self.crash_hook(point)

    @property
    def _logging(self) -> bool:
        """Writes are being logged: durable and not replaying the log."""
        return self._wal is not None and not self._replaying

    def _wal_append(self, rtype: int, payload: bytes = b"", *,
                    wait: bool = True):
        """Log one record *before* the mutation it describes (no-op when
        the engine is not durable or is replaying its own log).
        ``wait=False`` defers the group-commit durability wait: a write
        batch of several chunks waits once, at its end
        (``_wal_wait_durable``)."""
        if not self._logging:
            return
        self._wal.append(rtype, payload, wait=wait)
        self._crash("wal_appended")

    def _wal_wait_durable(self):
        """A write batch's durability point for ``wait=False`` appends
        (no-op outside group-commit mode)."""
        if self._logging:
            self._wal.wait_durable()

    def _pad_write(self, ids, vectors=None):
        """Ids (int64) and vectors on the device, padded to the write
        bucket (-1 ids are no-ops)."""
        ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1).to(
            self.device)
        n = ids.shape[0]
        pad = _bucket(n, self.config.stream.write_bucket) - n
        if pad:
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        if vectors is None:
            return ids, None
        vectors = torch.as_tensor(vectors, dtype=torch.float32).to(
            self.device).reshape(n, -1)
        if pad:
            vectors = torch.nn.functional.pad(vectors, (0, 0, 0, pad))
        return ids, vectors

    def _compact_point(self) -> int:
        """Delta fill (rows) that triggers auto-compaction."""
        scfg = self.config.stream
        fill = scfg.compact_threshold
        if self._policy is not None and self._policy.config.delta_fill:
            fill = self._policy.config.delta_fill
        return max(1, min(scfg.delta_capacity,
                          int(fill * scfg.delta_capacity)))

    def _ensure_delta_room(self, chunk: int, cap: int, point: int):
        """Compact (blocking or in the background) so ``chunk`` more delta
        rows fit."""
        if self._compact_future is not None:
            if (self._delta_used + chunk > cap
                    or self._tail_rows + chunk > point):
                self.finish_compact()
            else:
                return      # the pending fold reclaims the delta at the swap
        if self._delta_used + chunk > point:
            if (self._compact_future is None
                    and self.config.stream.background_compact
                    and self._delta_used + chunk <= cap):
                self.begin_compact()
            else:
                self.compact()

    def upsert(self, ids, vectors) -> "SearchEngine":
        """Insert or overwrite rows by external id (ids (B,), vectors
        (B, D)): delta appends, in chunks of at most the compact point,
        the delta auto-compacting at ``compact_threshold``. Returns
        ``self``."""
        with span("write.upsert", self.device):
            self._require_stream()
            self._poll_compaction()
            host = None
            if self._logging:
                # the log's copy, from the caller's arrays before they move
                # (one copy a batch, on a durable engine only); every id is
                # checked before any record of the batch is written
                hid = check_ids(_host(ids))
                host = (hid, _host(vectors).astype(np.float32, copy=False)
                        .reshape(hid.shape[0], -1))
            ids = _on_device(ids, torch.int64, self.device).reshape(-1)
            vectors = _on_device(vectors, torch.float32,
                                 self.device).reshape(ids.shape[0], -1)
            cap = self.config.stream.delta_capacity
            point = self._compact_point()
            b = 0
            while b < ids.shape[0]:
                chunk = min(ids.shape[0] - b, point)
                if not self._replaying:
                    # a replayed log holds its compactions as RT_COMPACT
                    self._ensure_delta_room(chunk, cap, point)
                cid, cv = ids[b:b + chunk], vectors[b:b + chunk]
                if host is not None:
                    self._wal_append(RT_UPSERT, encode_upsert(
                        host[0][b:b + chunk], host[1][b:b + chunk]),
                        wait=False)
                if self._compact_future is not None:
                    # the pending fold works on a copy taken at its
                    # start: this write is replayed onto the folded store
                    # at the swap
                    self._compact_tail.append(("upsert", cid, cv))
                    self._tail_rows += chunk
                pid, pv = self._pad_write(cid, cv)
                # dropped stays 0: a chunk never exceeds the compact point
                self.store, _ = self._upsert(self.store, pid, pv)
                self._delta_used += chunk
                b += chunk
            self._wal_wait_durable()     # one group-commit wait a batch
        return self

    def delete(self, ids) -> "SearchEngine":
        """Delete rows by external id: tombstone base copies, punch delta
        holes (absent ids are no-ops). With a configured policy a dense
        tombstone bitmap triggers ``vacuum``. Returns ``self``."""
        with span("write.delete", self.device):
            self._require_stream()
            self._poll_compaction()
            if self._logging:
                self._wal_append(RT_DELETE, encode_delete(_host(ids)))
            ids = _on_device(ids, torch.int64, self.device).reshape(-1)
            if self._compact_future is not None:
                self._compact_tail.append(("delete", ids, None))
            pid, _ = self._pad_write(ids)
            self.store = self._delete(self.store, pid)
            if self._policy_active and not self._replaying:
                count("host_syncs", 2)
                decision = self._policy.decide_delete(
                    dead=int(self.store.dead.sum()),
                    allocated=int(self.store.n_rows))
                if decision.kind == "vacuum":
                    self.vacuum()
        return self

    # --- compaction (blocking and on a worker thread) ---------------------

    def _run_compact(self, store):
        """The fold and grow-retry loop over ``store`` (written in place).
        Returns (folded store, grows)."""
        scfg = self.config.stream
        with span("write.compact", self.device):
            store, dropped = self._compact(store)
            grows = 0
            count("host_syncs")
            while int(dropped):
                # a delta's worth of cell slack covers every delta row
                # landing in one cell, so one grow suffices
                store = segments.grow_store(
                    store, row_extra=4 * scfg.delta_capacity,
                    cell_extra=scfg.delta_capacity)
                grows += 1
                store, dropped = self._compact(store)
                count("host_syncs")
        return store, grows

    def _compact_task(self, store, stream):
        self._crash("compact_task")
        # the fold is queued on the stream the caller serves on, behind
        # the copy it folds and in order with the searches
        if stream is None:
            return self._run_compact(store)
        with torch.cuda.stream(stream):
            return self._run_compact(store)

    def _install_compacted(self, store, grows, tail, tail_rows):
        """Replay the writes made during the fold onto the folded store,
        then swap it in with one reference assignment: a search sees the
        old store or the new one, never a mix."""
        for kind, tids, tvecs in tail:
            pid, pv = self._pad_write(tids, tvecs)
            if kind == "upsert":
                store, _ = self._upsert(store, pid, pv)
            else:
                store = self._delete(store, pid)
        self._crash("compact_swap")
        self.store = store
        self._delta_used = tail_rows
        self._base_dirty = True      # the fold rewrote the base tensors
        self.grow_count += grows
        self.counters["compactions"] += 1
        self.counters["swaps"] += 1
        if self._stream_sharded_base is not None:
            self._shard_stream_base()        # re-lay the (grown) base out
        self._crash("compact_done")
        if not self._replaying:      # a replayed log holds its decisions
            self._post_compact_maintenance()

    def compact(self) -> "SearchEngine":
        """Fold the delta segment into the base (coded against the frozen
        quantizers), blocking. A pending ``begin_compact`` is finished
        first. When the append would overflow the row capacity or a cell's
        slack the store grows and the fold retries (``grow_count``).
        Returns ``self``."""
        self._require_stream()
        if self._compact_future is not None:
            self.finish_compact()
        self._observe_drift()
        self._wal_append(RT_COMPACT)
        self._crash("compact_begin")
        store, grows = self._run_compact(self.store)
        self._install_compacted(store, grows, (), 0)
        return self

    def begin_compact(self) -> "SearchEngine":
        """Start a compaction on a worker thread: fold a copy of the store
        while searches and writes keep serving the live one;
        ``finish_compact`` (or the poll at the next search or write once
        the fold is done) replays the writes made meanwhile and swaps.
        On CUDA the copy and the fold are queued on the caller's current
        stream, so the folded store is complete, in stream order, before
        any later search reads it. No-op if one is pending. Returns
        ``self``."""
        self._require_stream()
        if self._compact_future is not None:
            return self
        self._observe_drift()
        self._wal_append(RT_COMPACT)
        self._crash("compact_begin")
        snapshot = tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            self.store)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        self._compact_tail = []
        self._tail_rows = 0
        if self._compact_executor is None:
            self._compact_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="qpad-compact")
        self._compact_future = self._compact_executor.submit(
            self._compact_task, snapshot, stream)
        return self

    def finish_compact(self) -> "SearchEngine":
        """Complete a pending ``begin_compact``: wait for the fold, replay
        the tail writes, swap. No-op without one. Returns ``self``."""
        self._require_stream()
        fut = self._compact_future
        if fut is None:
            return self
        try:
            store, grows = fut.result()
        finally:
            self._compact_future = None
        tail, self._compact_tail = self._compact_tail, []
        rows, self._tail_rows = self._tail_rows, 0
        self._install_compacted(store, grows, tail, rows)
        return self

    def _poll_compaction(self):
        """Swap in a background compaction whose fold has finished. On a
        sharded engine every rank folds on its own worker thread, so the
        swap is the mesh's decision: it happens once every rank's fold is
        done (an all-reduce MIN of the flags), else one search would scan
        the new base layout on some ranks and the old one on others. Every
        rank polls at the same calls (the same writes and searches start
        the same folds), so the collective is matched."""
        fut = self._compact_future
        if fut is None:
            return
        done = fut.done()
        if self._stream_sharded_base is not None:
            flag = torch.tensor([int(done)], dtype=torch.int32,
                                device=self._mesh.device)
            done = bool(all_reduce_min(self._mesh, flag)[0])
        if done:
            self.finish_compact()

    def close(self):
        """Finish a pending compaction, stop its worker thread and close
        the WAL (a durable engine takes no writes after this)."""
        if self.store is not None and self._compact_future is not None:
            self.finish_compact()
        if self._compact_executor is not None:
            self._compact_executor.shutdown(wait=True)
            self._compact_executor = None
        if self._wal is not None:
            self._wal.close()

    # --- maintenance policy ----------------------------------------------

    def _lut_noise_floor(self) -> float:
        """The smallest drift worth acting on: the LUT quantization error
        bound of the codeword norms."""
        cb = self.frozen.cbnorm if self.frozen is not None else None
        if cb is None or self.config.index not in ("pq", "opq", "ivfpq"):
            return 0.0
        count("host_syncs")
        return float(lut_error_bound(cb[None], self.config.lut_dtype)[0])

    def _observe_drift(self):
        """Feed the encode error of the delta rows about to be folded into
        the policy's drift estimate."""
        if not self._policy_active or self._replaying:
            return
        ops = get_ops(self.config.index)
        if ops.drift_stats is None:
            return
        store = self.store
        rows = (store.delta_reduced if store.delta_reduced is not None
                else store.delta_vectors)
        alive = segments.delta_alive(store)
        count("host_syncs")
        n = int(alive.sum())
        if n == 0:
            return
        err = ops.drift_stats(self.frozen, rows)
        count("host_syncs")
        self._policy.observe_encode_error(
            float(torch.where(alive, err, 0.0).sum()) / n, n)

    def _post_compact_maintenance(self):
        """The post-compaction policy decision (grow / rebuild)."""
        if not self._policy_active:
            return
        scfg = self.config.stream
        count("host_syncs")
        free = int(self.store.corpus.shape[0]) - int(self.store.n_rows)
        decision = self._policy.decide_post_compact(
            free_rows=free, delta_capacity=scfg.delta_capacity,
            noise_floor=self._lut_noise_floor())
        if decision.kind == "grow":
            self._wal_append(RT_POLICY, encode_policy(
                {"decision": "grow", **decision.params}))
            self._grow(**decision.params)
        elif decision.kind == "rebuild":
            self.rebuild_quantizers()

    def _grow(self, row_extra: int, cell_extra: int):
        self.store = segments.grow_store(self.store, row_extra=row_extra,
                                         cell_extra=cell_extra)
        self._base_dirty = True
        self.counters["policy_grows"] += 1
        if self._stream_sharded_base is not None:
            self._shard_stream_base()

    def _gather_live(self):
        """Every live row: base survivors in row order, then live delta
        rows in slot order. Returns (vectors (L, D), external ids (L,))."""
        store = self.store
        live = segments.live_mask(store)
        alive = segments.delta_alive(store)
        vectors = torch.cat([store.corpus[live], store.delta_vectors[alive]])
        ext = torch.cat([store.row_ids[live], store.delta_ids[alive]])
        return vectors, ext

    def vacuum(self) -> "SearchEngine":
        """Reclaim tombstoned rows: rewrite the base over the live rows
        (the delta folded in) with the FROZEN quantizers, back to the
        configured capacities. Returns ``self``."""
        self._require_stream()
        if self._compact_future is not None:
            self.finish_compact()
        self._wal_append(RT_POLICY, encode_policy({"decision": "vacuum"}))
        self._crash("vacuum")
        self._do_vacuum()
        return self

    def _do_vacuum(self):
        vectors, ext = self._gather_live()
        state = segments.rebuild_state(self.frozen, vectors)
        store, frozen = segments.make_mutable(state, self.config.stream)
        store.row_ids[:ext.shape[0]] = ext
        self.store, self.frozen = store, frozen
        self._delta_used = 0
        self._base_dirty = True
        self.counters["vacuums"] += 1
        if self._stream_sharded_base is not None:
            self._shard_stream_base()

    def rebuild_quantizers(self, seed: Optional[int] = None
                           ) -> "SearchEngine":
        """Retrain the quantizers over the live rows through the ordinary
        build (a new fit and index, a fresh drift baseline), keeping the
        external ids. Returns ``self``."""
        self._require_stream()
        if self._compact_future is not None:
            self.finish_compact()
        if seed is None:
            seed = self.config.seed + 1 + self.counters["rebuilds"]
        self._wal_append(RT_POLICY, encode_policy(
            {"decision": "rebuild", "seed": int(seed)}))
        self._crash("rebuild")
        self._do_rebuild(int(seed))
        return self

    def _do_rebuild(self, seed: int):
        vectors, ext = self._gather_live()
        cfg = dataclasses.replace(self.config, seed=seed)
        fresh = SearchEngine(vectors, cfg, device=self.device)
        fresh.store.row_ids[:ext.shape[0]] = ext
        decisions = self._policy.decisions if self._policy else {}
        self.config = cfg
        self.store, self.frozen = fresh.store, fresh.frozen
        self._policy = fresh._policy             # fresh drift baseline
        self._policy_active = fresh._policy_active
        self._policy.decisions = decisions
        self._delta_used = 0
        self._base_dirty = True
        self._reset_stream_programs()        # new quantizers: re-keyed
        self.counters["rebuilds"] += 1
        if self._stream_sharded_base is not None:
            self._shard_stream_base()

    def _apply_policy_record(self, decision: dict):
        """Replay one RT_POLICY record (recovery and catch-up)."""
        kind = decision.get("decision")
        if kind == "vacuum":
            self._do_vacuum()
        elif kind == "grow":
            self._grow(row_extra=int(decision["row_extra"]),
                       cell_extra=int(decision["cell_extra"]))
        elif kind == "rebuild":
            self._do_rebuild(int(decision["seed"]))
        else:
            raise ValueError(f"unknown policy decision {decision!r}")

    # --- durability -------------------------------------------------------

    def durable(self, directory: str, config=None) -> "SearchEngine":
        """Make this streaming engine durable: open a write-ahead log under
        ``directory/wal`` and take the initial full snapshot in
        ``directory``. From here on every ``upsert`` chunk, ``delete``,
        compaction and policy decision is logged *before* it changes the
        store, ``save`` to the same directory marks and truncates the log,
        and ``load_engine(directory)`` recovers the exact store after a
        crash (snapshot + replay of the log's tail). ``config`` is a
        ``durability.DurabilityConfig`` (fsync mode, segment size, group
        commit). Ids must lie in the int32 range, the log's id width.
        Returns ``self``."""
        self._require_stream()
        if self._wal is not None:
            raise RuntimeError(
                "this engine is already durable; one WAL per engine "
                f"(directory {self._durable_dir!r})")
        config = config or DurabilityConfig()
        if config.role == "follower" or self._role == "follower":
            raise ValueError(
                "durable(role='follower') is incoherent: a follower "
                "tails a primary's shipped WAL and never owns a local "
                "one (local writes on a follower would fork the "
                "history). Seed a follower with load_engine(snapshot, "
                "role='follower') + durability.replication.catch_up; "
                "use role='primary' (the default) for a writable node.")
        os.makedirs(directory, exist_ok=True)
        self._wal = Wal(os.path.join(directory, "wal"), config)
        self._durability = config
        self._durable_dir = os.path.abspath(directory)
        self.save(directory)                 # the initial durable snapshot
        return self

    # --- observability ----------------------------------------------------

    def metrics(self):
        """The engine's typed metrics snapshot: a
        ``repro_torch.search.metrics.EngineMetrics`` of frozen dataclasses
        with the JAX package's stable dotted names (``wal.records``,
        ``stream.fill``, ``compact.pending``, ``policy.drift_ema``,
        ``replication.follower_lag_seq``, ...). Sections that do not apply
        to this engine are ``None``. The launcher's ``--metrics-port``
        endpoint serves it."""
        from .metrics import collect_metrics
        return collect_metrics(self)

    def tracing(self, config=None, **knobs) -> "SearchEngine":
        """Attach request-level observability (``tracing``): latency
        histograms into ``metrics().latency``, sampled deep traces
        (``deep_trace_every=N``), slow-query capture (``slow_query_ms=T``),
        shadow-exact recall estimation (``recall_every=N``) and
        Chrome-trace export (``trace_dir=``).

        Pass a ``TraceConfig`` or its fields as keyword knobs; with no
        arguments it attaches the cheap production default (end-to-end
        histograms only). Detach with ``engine.tracer = None``. Returns
        ``self``."""
        from .tracing import TraceConfig, Tracer
        if config is None:
            config = TraceConfig(**knobs)
        elif knobs:
            config = dataclasses.replace(config, **knobs)
        self._tracer = Tracer(config)
        return self

    @property
    def tracer(self):
        """The attached ``Tracer`` (None when tracing is off)."""
        return self._tracer

    @tracer.setter
    def tracer(self, value):
        self._tracer = value

    @property
    def trace_dir(self) -> Optional[str]:
        """Chrome-trace export directory (None = event capture off).
        Setting it attaches or updates the tracer in place."""
        return (self._tracer.config.trace_dir
                if self._tracer is not None else None)

    @trace_dir.setter
    def trace_dir(self, directory: Optional[str]):
        from .tracing import TraceConfig, Tracer
        if self._tracer is None:
            self._tracer = Tracer(TraceConfig(trace_dir=directory))
        else:
            self._tracer.config = dataclasses.replace(
                self._tracer.config, trace_dir=directory)

    def flush_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the buffered trace events as Chrome-trace JSON; returns
        the path (None when no tracer or event capture is attached)."""
        if self._tracer is None:
            return None
        return self._tracer.flush(path)


def _host(a) -> np.ndarray:
    """A host (numpy) view or copy of a caller's array or tensor."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            count("host_syncs")
        return a.detach().cpu().numpy()
    return np.asarray(a)


def as_serve_config(config) -> ServeConfig:
    """Normalize an engine config: a ``ServeConfig`` passes through; an
    ``IndexSpec`` or a spec string (``"qpad32>ivf64x8>pq8x256:i8"``) is
    lowered with ``config_from_spec``."""
    if isinstance(config, ServeConfig):
        return config
    if isinstance(config, (str, IndexSpec)):
        return config_from_spec(config)
    raise TypeError("expected a ServeConfig, an IndexSpec, or a spec string "
                    f"like 'qpad32>ivf64x8>pq8x256:i8'; got "
                    f"{type(config).__name__}")


def build_engine(corpus, spec, *, device: DeviceLike = None,
                 inits: Optional[BuildInits] = None,
                 **runtime) -> SearchEngine:
    """Build a serving engine from a pipeline spec (an ``IndexSpec``, a
    spec string such as ``"qpad32>ivf64x8>pq8x256:i8"``, or a full
    ``ServeConfig``); ``runtime`` forwards engine knobs the spec does not
    carry (``query_bucket``, ``mpad``, ``fit_sample``, ``seed``, ...)."""
    if isinstance(spec, ServeConfig):
        cfg = dataclasses.replace(spec, **runtime) if runtime else spec
    else:
        cfg = config_from_spec(spec, **runtime)
    return SearchEngine(corpus, cfg, device=device, inits=inits)
