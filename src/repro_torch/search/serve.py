"""Batched vector-search serving engine (port of the single-device
read-only half of ``repro.search.serve``).

Pipeline: corpus -> [fit MPAD on a sample] -> reduce the corpus -> build
the index over the reduced vectors -> serve batched queries: reduce the
query -> probe/scan in the reduced space -> exact re-rank of the
candidates in the original space -> top-k.

``EngineState`` holds the re-rank corpus, the fitted projection and the
built index; ``search_fn(state, queries, k, ...)`` is the whole query
pipeline as one function of tensors. ``SearchEngine`` builds the state
once and pads each query batch to a power-of-two bucket, as the JAX engine
does, so both packages run the same scan shapes; small ivfpq buckets take
the compact scan when the posting-mass bound allows it.

Not ported yet (see ROADMAP.md): the re-rank pre-filter
(``prefilter_batch``), streaming, sharding, snapshots, the WAL, metrics and
tracing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, cpu_generator, resolve_device
from repro_torch.core.mpad import MPADConfig
from repro_torch.kernels.pq_adc.lut import LUT_DTYPES

from .knn import topk_smallest
from .reducers import Reducer, fit_reducer, reduce_vectors
from .registry import (INDEX_KINDS, BuildInits, Index, ScanParams, get_ops)
from .spec import IndexSpec, parse_spec, spec_from_config

__all__ = ["ServeConfig", "SearchEngine", "EngineState", "search_fn",
           "exact_rerank", "build_engine", "config_from_spec"]

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
    mpad: Optional[MPADConfig] = None    # defaults derived from target_dim
    fit_sample: int = 2048               # rows used to fit the projection
    seed: int = 0

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


def _check_rerank_budget(approximate: bool, rerank: int, k: int):
    if approximate and rerank < k:
        raise ValueError(
            f"k={k} exceeds the re-rank budget rerank={rerank} on an "
            "approximate pipeline (reduction and/or PQ codes): the exact "
            "re-rank could only return rerank candidates. Raise the "
            f"Rerank stage (e.g. spec '...>rr{k}') or lower k.")


def search_fn(state: EngineState, queries: torch.Tensor, k: int, *,
              nprobe: int = 8, rerank: int = 64, backend: str = "jnp",
              lut_dtype: str = "f32", scan_cap: int = 0):
    """The query pipeline: project -> probe/scan (dispatched on the index
    kind) -> exact re-rank -> top-k. Returns (dists (Q, k), ids (Q, k)),
    distances in the original space."""
    ops = get_ops(state.index.kind)
    queries = queries.to(torch.float32)
    qr = reduce_vectors(state.proj, queries)
    approximate = state.proj is not None or ops.lossy
    _check_rerank_budget(approximate, rerank, k)
    n_cand = rerank if approximate else k
    p = ScanParams(nprobe=nprobe, backend=backend, lut_dtype=lut_dtype,
                   scan_cap=scan_cap)
    _, cand = ops.scan(state, qr, n_cand, p)
    return exact_rerank(queries, state.corpus, cand, k)


def _bucket(nq: int, floor: int, small: int = 0) -> int:
    """Smallest power of two >= nq, floored at ``floor``; batches of at
    most ``small`` take their own power-of-two bucket."""
    pow2 = 1 << max(nq - 1, 0).bit_length()
    if 0 < nq <= small:
        return pow2
    return max(floor, pow2)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SearchEngine:
    """Build once over a corpus; serve batched k-NN queries.

    Runs on CUDA unless ``device`` says otherwise (and raises when no CUDA
    device is present and none was named). ``inits`` (``BuildInits``)
    replaces the engine's random draws with explicit ones; the rest come
    from a CPU ``torch.Generator`` seeded with ``config.seed``: the fit
    sample rows, then the coarse k-means start, then the PQ starts.
    ``build_seconds`` records the host time of each build stage.
    """

    def __init__(self, corpus, config=ServeConfig(), *,
                 device: DeviceLike = None,
                 inits: Optional[BuildInits] = None):
        config = _as_serve_config(config)
        spec = config.to_spec()
        self.device = resolve_device(device)
        inits = inits if inits is not None else BuildInits()
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
                               w0=inits.w0)
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

    @classmethod
    def from_state(cls, state: EngineState, config) -> "SearchEngine":
        """An engine around already-built tensors (e.g. a state carried
        across from the JAX package by ``repro_torch.bridge``)."""
        eng = object.__new__(cls)
        eng.device = state.corpus.device
        eng.build_seconds = {}
        eng._attach(_as_serve_config(config), state)
        return eng

    def _attach(self, config: ServeConfig, state: EngineState):
        self.config = config
        self.state = state
        self.last_bucket: Optional[int] = None
        self._scan_caps: dict = {}   # nprobe -> compact-scan gather width

    def _scan_cap(self, nprobe: int) -> int:
        """Compact-scan gather width at ``nprobe``: the sum of the
        ``nprobe`` largest cell fills rounded up to 128, so the compact
        scan never truncates a query's candidates. 0 (off) unless it cuts
        well over a third of the padded ``nprobe * max_cell`` slots.
        Host-side and cached per nprobe."""
        cap = self._scan_caps.get(nprobe)
        if cap is None:
            lists = self.state.index.payload.lists
            lens = (lists >= 0).sum(dim=1).cpu().numpy()
            top = np.sort(lens)[-nprobe:]
            cap = -(-int(top.sum()) // 128) * 128
            if cap * 8 >= nprobe * lists.shape[1] * 5:
                cap = 0
            self._scan_caps[nprobe] = cap
        return cap

    def search(self, queries, k: int):
        """Returns (dists (Q, k), ids (Q, k)) on the engine's device. The
        batch is zero-padded to its power-of-two bucket, then sliced back."""
        cfg = self.config
        ops = get_ops(cfg.index)
        _check_rerank_budget(cfg.target_dim is not None or ops.lossy,
                             cfg.rerank, k)
        queries = torch.as_tensor(queries, dtype=torch.float32).to(
            self.device)
        nq = queries.shape[0]
        bucket = _bucket(nq, cfg.query_bucket, cfg.small_batch)
        self.last_bucket = bucket
        if bucket != nq:
            queries = torch.nn.functional.pad(queries, (0, 0, 0, bucket - nq))
        kw = dict(nprobe=cfg.nprobe, rerank=cfg.rerank,
                  backend=cfg.pq_backend, lut_dtype=cfg.lut_dtype,
                  scan_cap=0)
        if cfg.index == "ivfpq" and 0 < bucket <= cfg.compact_batch:
            kw["scan_cap"] = self._scan_cap(cfg.nprobe)
        d, ids = search_fn(self.state, queries, k, **kw)
        return d[:nq], ids[:nq]


def _as_serve_config(config) -> ServeConfig:
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
