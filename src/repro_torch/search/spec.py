"""Declarative index-pipeline specs: the composable serving API (a copy of
``repro.search.spec``: the same grammar, so one spec string drives both
packages).

QPAD's thesis is that dimension reduction *composes* with the downstream
ANN machinery — reduce, then coarse-quantize, then code, then exact
re-rank — and this module makes that composition the first-class object
(the shape GleanVec's DR-then-scan pipelines and "Quantization Meets
Projection"'s DR+PQ marriage treat as primary). An ``IndexSpec`` is a
typed pipeline of stages:

    Reduce(m, kind)  ->  Coarse(nlist, nprobe)  ->  Code(subspaces,
                                                        centroids,
                                                        lut_dtype,
                                                        backend, kind)
                                                ->  Rerank(n)

Every stage except ``Rerank`` is optional; the stage combination
determines the index kind (``IndexSpec.kind``):

    no Coarse, no Code   ->  "flat"    exact scan
    Coarse only          ->  "ivf"     probed exact scan
    Code(kind="pq")      ->  "pq"      fused ADC scan
    Code(kind="opq")     ->  "opq"     learned rotation + fused ADC scan
    Coarse + Code        ->  "ivfpq"   probed ADC scan over residual codes

The ``Reduce`` stage is itself pluggable: its ``kind`` names an entry in
the reducer registry (``repro_torch.search.reducers`` — ``qpad`` | ``pca`` |
``mlp``), mirroring how the stage combination names an entry in the
index registry.

Specs also have a FAISS-factory-style **string grammar** (parser and
printer round-trip)::

    spec   := "flat" | stage (">" stage)*        stages in pipeline order
    stage  := RED M                              Reduce(m=M, kind=RED)
            | "flat"                             exact scan (no ivf/code)
            | "ivf" NLIST "x" NPROBE             Coarse(nlist, nprobe)
            | CODE M "x" K [":" LUT] ["@" BACK]  Code(subspaces=M,
                                                      centroids=K,
                                                      kind=CODE, ...)
            | "rr" N                             Rerank(n=N)
    RED    := "qpad" | "pca" | "mlp"             registered reducer kinds
    CODE   := "pq" | "opq"                       plain / OPQ-rotated PQ
    LUT    := "f32" | "bf16" | "i8" | "int8"     ADC table precision
    BACK   := "jnp" | "kernel"                   ADC scoring backend

e.g. ``"qpad32>ivf64x8>pq8x256:i8"`` = MPAD to 32 dims, 64 coarse cells
probing 8, 8x256 residual PQ codes scored through int8 LUTs, default
64-candidate exact re-rank; ``"pca32>opq8x256"`` = PCA to 32 dims then
OPQ-rotated 8x256 codes. ``parse_spec``/``format_spec`` round-trip:
``parse_spec(format_spec(s)) == s`` for every spec value.

Validation is **stage-level**: each stage checks its own knobs in
``__post_init__`` (e.g. ``Coarse`` rejects ``nprobe > nlist`` — probing
more cells than exist was previously clamped inside the jitted scan), and
the spec cannot *express* dead knobs — there is no ``nlist`` without a
``Coarse`` stage. The legacy flat ``ServeConfig`` keeps working through
``spec_from_config``, which lowers it onto a spec and rejects knobs the
selected pipeline has no stage for.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

from repro_torch.kernels.pq_adc.lut import LUT_DTYPES

from .reducers import REDUCER_KINDS

__all__ = ["Reduce", "Coarse", "Code", "Rerank", "IndexSpec",
           "parse_spec", "format_spec", "spec_from_config"]

ADC_BACKENDS = ("jnp", "kernel")
CODE_KINDS = ("pq", "opq")
DEFAULT_RERANK = 64

# grammar aliases: token in a spec string -> canonical lut_dtype
_LUT_TOKENS = {"f32": "f32", "bf16": "bf16", "i8": "int8", "int8": "int8"}
_LUT_PRINT = {"f32": "f32", "bf16": "bf16", "int8": "i8"}


@dataclasses.dataclass(frozen=True)
class Reduce:
    """Dimension reduction: project the corpus D -> ``m`` dims with the
    registered reducer ``kind`` (``qpad`` — the MPAD projection — by
    default; see ``repro_torch.search.reducers``)."""
    m: int
    kind: str = "qpad"

    def __post_init__(self):
        if self.m < 1:
            raise ValueError(f"Reduce(m={self.m}): m must be >= 1")
        if self.kind not in REDUCER_KINDS:
            raise ValueError(
                f"Reduce(kind={self.kind!r}): unknown reducer kind; "
                f"registered kinds: {REDUCER_KINDS} "
                "(register new ones via repro_torch.search.reducers."
                "register_reducer)")


@dataclasses.dataclass(frozen=True)
class Coarse:
    """Coarse k-means quantizer: ``nlist`` cells, probe ``nprobe``/query."""
    nlist: int
    nprobe: int = 8

    def __post_init__(self):
        if self.nlist < 1:
            raise ValueError(f"Coarse(nlist={self.nlist}): nlist must "
                             "be >= 1")
        if self.nprobe < 1:
            raise ValueError(f"Coarse(nprobe={self.nprobe}): nprobe must "
                             "be >= 1")
        if self.nprobe > self.nlist:
            raise ValueError(
                f"Coarse(nlist={self.nlist}, nprobe={self.nprobe}): "
                f"nprobe exceeds nlist — cannot probe more cells than "
                f"exist; lower nprobe or raise nlist (nprobe == nlist "
                "already scans every cell)")


@dataclasses.dataclass(frozen=True)
class Code:
    """PQ coding: ``subspaces`` x ``centroids`` codebooks + ADC scan knobs.

    ``kind="opq"`` prepends a learned orthogonal rotation (alternating
    Procrustes / assignment, OPQ-style) to the coder — the codes cover
    the rotated scan space, and every ADC scan path rotates the query
    first. Distances are rotation-invariant, so the delta/re-rank
    machinery is shared with plain ``pq`` unchanged.
    """
    subspaces: int = 8
    centroids: int = 256
    lut_dtype: str = "f32"
    backend: str = "jnp"
    kind: str = "pq"

    def __post_init__(self):
        if self.kind not in CODE_KINDS:
            raise ValueError(
                f"Code(kind={self.kind!r}): expected one of {CODE_KINDS}")
        if self.subspaces < 1:
            raise ValueError(f"Code(subspaces={self.subspaces}): must "
                             "be >= 1")
        if self.centroids < 2:
            raise ValueError(f"Code(centroids={self.centroids}): a "
                             "codebook needs >= 2 codewords")
        if self.lut_dtype not in LUT_DTYPES:
            raise ValueError(
                f"Code(lut_dtype={self.lut_dtype!r}): expected one of "
                f"{LUT_DTYPES}")
        if self.backend not in ADC_BACKENDS:
            raise ValueError(
                f"Code(backend={self.backend!r}): expected one of "
                f"{ADC_BACKENDS} (pq_backend)")


@dataclasses.dataclass(frozen=True)
class Rerank:
    """Exact re-rank of the top ``n`` candidates in the original space."""
    n: int = DEFAULT_RERANK

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"Rerank(n={self.n}): n must be >= 1")


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """A serving pipeline: optional Reduce/Coarse/Code stages + Rerank.

    The stage combination is the index kind (``.kind``); validation is
    per-stage plus the composition checks here. Hashable and immutable,
    so a spec can key compile caches directly.
    """
    reduce: Optional[Reduce] = None
    coarse: Optional[Coarse] = None
    code: Optional[Code] = None
    rerank: Rerank = Rerank()

    def __post_init__(self):
        for field, cls in (("reduce", Reduce), ("coarse", Coarse),
                           ("code", Code)):
            val = getattr(self, field)
            if val is not None and not isinstance(val, cls):
                raise TypeError(f"IndexSpec.{field} must be a {cls.__name__}"
                                f" (or None), got {type(val).__name__}")
        if not isinstance(self.rerank, Rerank):
            raise TypeError("IndexSpec.rerank must be a Rerank stage, got "
                            f"{type(self.rerank).__name__}")
        if (self.coarse is not None and self.code is not None
                and self.code.kind == "opq"):
            raise ValueError(
                "Coarse + Code(kind='opq') is not a registered pipeline: "
                "the OPQ rotation is fitted on the whole scan space, which "
                "residual coding under a coarse quantizer would invalidate "
                "per cell. Use 'opq<M>x<K>' without an ivf stage, or "
                "'ivf<nlist>x<nprobe>>pq<M>x<K>' for coarse + codes.")

    @property
    def kind(self) -> str:
        """The index layout this pipeline lowers to (registry key)."""
        if self.coarse is not None and self.code is not None:
            return "ivfpq"
        if self.coarse is not None:
            return "ivf"
        if self.code is not None:
            return self.code.kind       # "pq" | "opq"
        return "flat"

    @property
    def approximate(self) -> bool:
        """True when scan-space scores are lossy (reduction or PQ codes),
        i.e. the over-retrieve + exact re-rank stage is load-bearing."""
        return self.reduce is not None or self.code is not None

    def stages(self):
        """The present stages, in pipeline order."""
        return tuple(s for s in (self.reduce, self.coarse, self.code,
                                 self.rerank) if s is not None)

    def __str__(self) -> str:
        return format_spec(self)


# the generic reduce token (<kind><m>) is tried LAST so every
# fixed-prefix stage token (ivf.., pq.., opq.., rr..) wins first; the
# matched kind is then validated against the reducer registry
_STAGE_RES = (
    ("coarse", re.compile(r"ivf(\d+)x(\d+)$")),
    ("code", re.compile(
        r"(pq|opq)(\d+)x(\d+)(?::(f32|bf16|i8|int8))?(?:@(jnp|kernel))?$")),
    ("rerank", re.compile(r"rr(\d+)$")),
    ("reduce", re.compile(r"([a-z]+)(\d+)$")),
)
_ORDER = {"reduce": 0, "coarse": 1, "code": 2, "rerank": 3}

_GRAMMAR_HINT = (
    "expected 'flat' or '>'-joined stages in pipeline order: "
    f"<reducer><m> (reducer in {'|'.join(REDUCER_KINDS)}) | flat | "
    "ivf<nlist>x<nprobe> | pq<M>x<K>[:f32|bf16|i8][@jnp|kernel] | "
    "opq<M>x<K>[:...] | rr<n> (e.g. 'qpad32>ivf64x8>pq8x256:i8')")


def parse_spec(s: str) -> IndexSpec:
    """Parse the string grammar into an ``IndexSpec`` (see module doc).

    Inverse of ``format_spec``. Raises ``ValueError`` with the grammar on
    unknown tokens, out-of-order stages, or repeated stages.
    """
    if not isinstance(s, str):
        raise TypeError(f"spec string expected, got {type(s).__name__}")
    text = s.strip().lower()
    if not text:
        raise ValueError(f"empty index spec; {_GRAMMAR_HINT}")
    if text == "flat":
        return IndexSpec()
    stages: dict = {}
    last = -1
    flat = False
    for token in text.split(">"):
        token = token.strip()
        if token == "flat":
            # explicit exact-scan marker: the pipeline has no Coarse/Code
            # stage (e.g. 'mlp16>flat' = reduce, then exact scan)
            if flat:
                raise ValueError(
                    f"duplicate 'flat' token in spec {s!r}")
            if _ORDER["coarse"] < last:
                raise ValueError(
                    f"stage 'flat' out of pipeline order in spec {s!r}; "
                    "order is <reducer> > flat > rr")
            flat = True
            last = _ORDER["coarse"]
            continue
        for name, rx in _STAGE_RES:
            m = rx.match(token)
            if m:
                break
        else:
            raise ValueError(
                f"unknown stage token {token!r} in spec {s!r}; "
                f"{_GRAMMAR_HINT}")
        if name in stages:
            raise ValueError(
                f"duplicate {name} stage ({token!r}) in spec {s!r}")
        if _ORDER[name] < last:
            raise ValueError(
                f"stage {token!r} out of pipeline order in spec {s!r}; "
                "order is <reducer> > ivf > pq|opq > rr")
        last = _ORDER[name]
        if name == "reduce":
            kind = m.group(1)
            if kind in ("ivf", "pq", "opq", "rr"):
                # a fixed-prefix stage with malformed decorations (e.g.
                # 'ivf64' without xNPROBE), not a reducer named 'ivf'
                raise ValueError(
                    f"malformed {kind} stage token {token!r} in spec "
                    f"{s!r}; {_GRAMMAR_HINT}")
            if kind not in REDUCER_KINDS:
                raise ValueError(
                    f"unknown reducer kind {kind!r} in stage {token!r} of "
                    f"spec {s!r}; registered reducer kinds: "
                    f"{REDUCER_KINDS}. {_GRAMMAR_HINT}")
            stages[name] = Reduce(m=int(m.group(2)), kind=kind)
        elif name == "coarse":
            stages[name] = Coarse(nlist=int(m.group(1)),
                                  nprobe=int(m.group(2)))
        elif name == "code":
            stages[name] = Code(
                kind=m.group(1),
                subspaces=int(m.group(2)), centroids=int(m.group(3)),
                lut_dtype=_LUT_TOKENS[m.group(4) or "f32"],
                backend=m.group(5) or "jnp")
        else:
            stages[name] = Rerank(n=int(m.group(1)))
    if flat and ("coarse" in stages or "code" in stages):
        extra = stages.get("coarse") or stages.get("code")
        raise ValueError(
            f"spec {s!r} mixes 'flat' (exact scan) with a "
            f"{type(extra).__name__} stage; drop one of them")
    return IndexSpec(**stages)


def format_spec(spec: IndexSpec) -> str:
    """Print a spec in the canonical string grammar.

    Inverse of ``parse_spec``: default-valued decorations (f32 LUTs, jnp
    backend, default rerank) are omitted, so
    ``parse_spec(format_spec(spec)) == spec`` and
    ``format_spec(parse_spec(s))`` is the canonical form of ``s``.
    """
    parts = []
    if spec.reduce is not None:
        parts.append(f"{spec.reduce.kind}{spec.reduce.m}")
    if spec.coarse is not None:
        parts.append(f"ivf{spec.coarse.nlist}x{spec.coarse.nprobe}")
    if spec.code is not None:
        tok = f"{spec.code.kind}{spec.code.subspaces}x{spec.code.centroids}"
        if spec.code.lut_dtype != "f32":
            tok += f":{_LUT_PRINT[spec.code.lut_dtype]}"
        if spec.code.backend != "jnp":
            tok += f"@{spec.code.backend}"
        parts.append(tok)
    if spec.rerank.n != DEFAULT_RERANK:
        parts.append(f"rr{spec.rerank.n}")
    return ">".join(parts) if parts else "flat"


def spec_from_config(cfg) -> IndexSpec:
    """Lower a legacy flat ``ServeConfig`` onto a pipeline spec.

    The adapter that keeps ``ServeConfig(index=...)`` working: the
    index-pipeline knobs map onto stages, and knobs the selected pipeline
    has **no stage for** are rejected when set away from their defaults
    (previously e.g. ``nlist`` silently meant nothing under
    ``index="pq"``). Duck-typed over the config's dataclass fields so this
    module stays import-light.
    """
    kind = cfg.index
    if kind not in ("flat", "ivf", "pq", "opq", "ivfpq"):
        raise ValueError(
            f"unknown index kind {kind!r}; expected one of "
            "('flat', 'ivf', 'pq', 'opq', 'ivfpq')")
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
    coarse_knobs = ("nlist", "nprobe")
    code_knobs = ("pq_subspaces", "pq_centroids", "lut_dtype", "pq_backend")
    dead = []
    if kind in ("ivf", "ivfpq"):
        coarse = Coarse(nlist=cfg.nlist, nprobe=cfg.nprobe)
    else:
        coarse = None
        dead += [(k, "Coarse") for k in coarse_knobs
                 if getattr(cfg, k) != defaults[k]]
    if kind in ("pq", "opq", "ivfpq"):
        code = Code(subspaces=cfg.pq_subspaces, centroids=cfg.pq_centroids,
                    lut_dtype=cfg.lut_dtype, backend=cfg.pq_backend,
                    kind="opq" if kind == "opq" else "pq")
    else:
        code = None
        dead += [(k, "Code") for k in code_knobs
                 if getattr(cfg, k) != defaults[k]]
    reducer = getattr(cfg, "reducer", "qpad")
    if cfg.target_dim is None:
        dead += [("reducer", "Reduce")] if reducer != "qpad" else []
    elif reducer != "qpad" and getattr(cfg, "mpad", None) is not None:
        raise ValueError(
            f"mpad= configures the 'qpad' reducer fit, but reducer="
            f"{reducer!r} is selected — drop mpad, or use reducer='qpad'")
    if dead:
        knobs = ", ".join(f"{k}={getattr(cfg, k)!r} (needs a {s} stage)"
                          for k, s in dead)
        raise ValueError(
            f"dead knob(s) for index={kind!r}: {knobs}. The {kind!r} "
            "pipeline has no stage that reads them — drop them, or select "
            "a pipeline that has the stage (e.g. spec "
            "'qpad32>ivf64x8>pq8x256').")
    reduce = (Reduce(m=cfg.target_dim, kind=reducer)
              if cfg.target_dim is not None else None)
    return IndexSpec(reduce=reduce, coarse=coarse, code=code,
                     rerank=Rerank(n=cfg.rerank))
