"""Engine snapshot persistence: spec + tensors, restore anywhere (port of
``repro.search.snapshot``; the files are the JAX package's, and each
package loads the other's).

``save_engine`` writes a serving engine into a directory as two pieces:

* ``engine.json``: the pipeline **spec string** (the grammar of
  ``repro_torch.search.spec``), the runtime knobs and the streaming
  config; everything needed to rebuild the engine's shape without the
  corpus. Schema ``qpad.engine_snapshot.v1``, the JAX package's fields.
* ``ckpt_%010d.npz``: every tensor, keyed by the path
  ``jax.tree_util.keystr`` gives it in the JAX package's tree
  (``['state'].corpus``, ``['state'].proj[0]``,
  ``['state'].index.payload.codes``, ``['store'].row_ids``,
  ``['frozen'].quant.payload.codebooks``, ...; ``snapshot_leaves``), with
  the JAX package's dtypes: ids, posting lists and counters int32 (the
  port's int64 narrowed, an id outside the int32 range refused), codes
  uint8 or int32, ``dead`` bool. Written through
  ``repro_torch.runtime.checkpoint.save_arrays`` (atomic write +
  retention). Read-only engines persist their ``EngineState``; streaming
  engines their ``StreamStore`` + ``FrozenParams``, the delta segment,
  tombstones and id maps included, so a snapshot taken **mid-delta**
  restores mid-delta.

``load_engine`` reads the tensors back through ``repro_torch.bridge``'s
readers (``state_from_arrays`` / ``stream_from_arrays``, which widen ids
to int64) and rebuilds the ``SearchEngine`` around them: no fit, no index
build.

On a **durable** engine (``engine.durable(dir)``) the snapshot directory
also holds the write-ahead log: ``save_engine`` commits crash-consistently
(fresh checkpoint step -> fsync'd ``engine.json`` replace -> WAL snapshot
mark + truncation) and ``load_engine`` replays the log's tail on top of
the restored store, so recovery lands on the exact pre-crash state (see
``repro_torch.search.durability``).

The JAX package's ``pq_interpret`` runtime knob (Pallas interpret mode)
has no counterpart here: the port writes it as ``false`` and ignores it
on read.

``load_engine(dir, mesh=...)`` restores onto a serving mesh: snapshots
are shard-agnostic, so every rank reads the whole snapshot onto its
device and keeps its slice (``SearchEngine.shard``; a read-only engine
frees the dense copy, a streaming one shards its base and keeps the
replicated write state).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch._device import DeviceLike
from repro_torch._tree import _children
from repro_torch.runtime.checkpoint import (_to_numpy, checkpoint_step,
                                            latest_checkpoint, save_arrays)

from .durability.policy import PolicyConfig
from .durability.wal import RT_SNAPSHOT, DurabilityConfig, Wal
from .reducers import Reducer
from .registry import Index
from .segments import StreamConfig
from .serve import SearchEngine, config_from_spec
from .spec import format_spec, parse_spec

__all__ = ["save_engine", "load_engine", "snapshot_leaves", "SNAPSHOT_META"]

SNAPSHOT_META = "engine.json"
_SCHEMA = "qpad.engine_snapshot.v1"
# engine knobs a pipeline spec does not carry; persisted verbatim (the
# JAX package's list: the port has no pq_interpret and writes False)
_RUNTIME_FIELDS = ("query_bucket", "small_batch", "compact_batch",
                   "prefilter_batch", "fit_sample", "seed", "pq_interpret")
_NO_COUNTERPART = {"pq_interpret": False}

# StreamStore fields that are optional per index kind / projection; which
# ones a snapshot carries is recorded in its meta at save time
_OPT_STORE_FIELDS = ("reduced", "codes", "bias", "lists", "codes_cell",
                     "bias_cell", "delta_reduced")

# StreamStore fields a pure delta write changes: everything an
# INCREMENTAL snapshot must carry. The base tensors (corpus, codes,
# lists, ... and the frozen quantizers) only change at compaction,
# vacuum, rebuild or grow, which dirties the base and forces the next
# snapshot to be full.
_INC_STORE_FIELDS = ("row_ids", "n_rows", "dead", "delta_vectors",
                     "delta_ids", "delta_count", "delta_reduced")

_I32 = np.iinfo(np.int32)


def snapshot_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr path, leaf), ...] of an engine tree, named as the JAX
    package's ``keystr`` names them there: a ``None`` subtree has no
    leaves, an ``Index`` is walked as ``.payload`` and a ``Reducer`` as
    ``.params`` (JAX registers both with their kind as metadata)."""
    if tree is None:
        return []
    if isinstance(tree, Index):
        return snapshot_leaves(tree.payload, prefix + ".payload")
    if isinstance(tree, Reducer):
        return snapshot_leaves(tree.params, prefix + ".params")
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in kids:
        out.extend(snapshot_leaves(child, prefix + key))
    return out


def _jax_array(key: str, leaf) -> np.ndarray:
    """A leaf on the host in the JAX package's dtype: int64 ids, lists and
    counters narrowed to int32 (refused outside its range), bf16 as its
    uint16 bits (``runtime.checkpoint``)."""
    arr = _to_numpy(leaf)
    if arr.dtype == np.int64:
        if arr.size and (arr.min() < _I32.min or arr.max() > _I32.max):
            raise ValueError(
                f"{key} holds a value outside the int32 range a snapshot "
                "stores ids in")
        arr = arr.astype(np.int32)
    return arr


def _arrays(tree) -> dict:
    return {key: _jax_array(key, leaf)
            for key, leaf in snapshot_leaves(tree)}


def _raw_proj(proj: Optional[Reducer]):
    """The Reduce stage as its RAW params (the JAX package's snapshots
    keep qpad's ``proj[0]`` / ``proj[1]`` paths); load rewraps."""
    return proj.params if proj is not None else None


def _prior_chain(directory: str):
    """Checkpoint basenames the existing manifest (if any) still
    references: retention must not unlink them while the new snapshot is
    mid-commit (a crash between the array write and the metadata replace
    must leave the old chain loadable)."""
    meta_path = os.path.join(directory, SNAPSHOT_META)
    if not os.path.isfile(meta_path):
        return set()
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return set()
    keep = set(meta.get("chain") or ())
    if meta.get("ckpt"):
        keep.add(meta["ckpt"])
    if meta.get("base_ckpt"):
        keep.add(meta["base_ckpt"])
    return keep


def _commit_meta(directory: str, meta: dict):
    tmp = os.path.join(directory, SNAPSHOT_META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        os.fsync(f.fileno())         # the commit point of the snapshot
    os.replace(tmp, os.path.join(directory, SNAPSHOT_META))


def _next_step(directory: str) -> int:
    prev = latest_checkpoint(directory)
    return checkpoint_step(prev) + 1 if prev else 0


def _meta(engine: SearchEngine, path: str, *, streaming: bool,
          flat_alias: bool, store_fields, wal_seq: int, durable: bool,
          **extra) -> dict:
    cfg = engine.config
    spec = engine.spec
    proj = engine.frozen.proj if streaming else engine.state.proj
    meta = {
        "schema": _SCHEMA,
        "spec": format_spec(spec),
        "kind": spec.kind,
        "streaming": streaming,
        "has_proj": proj is not None,
        "reducer": proj.kind if proj is not None else None,
        "flat_alias": flat_alias,
        "store_fields": list(store_fields),
        "ckpt": os.path.basename(path),
        "runtime": {f: (_NO_COUNTERPART[f] if f in _NO_COUNTERPART
                        else getattr(cfg, f)) for f in _RUNTIME_FIELDS},
        "stream": (dataclasses.asdict(cfg.stream)
                   if cfg.stream is not None else None),
        "wal_seq": wal_seq,
        "durability": (dataclasses.asdict(engine._durability)
                       if durable else None),
    }
    meta.update(extra)
    return meta


def save_engine(engine: SearchEngine, directory: str,
                incremental: bool = False) -> str:
    """Snapshot ``engine`` (spec + config + tensors) into ``directory``.
    Returns the checkpoint path.

    The write is **crash-consistent across the directory**: the tensors
    land under a fresh (incremented) checkpoint step, the metadata commits
    via an fsync'd temp file and ``os.replace``, and only *after* that
    commit is the engine's WAL (when this is its durable directory) marked
    with a SNAPSHOT record and truncated up to the saved sequence: a crash
    at any point leaves either the old snapshot + full log or the new
    snapshot + tail, never a mix.

    ``incremental=True`` (streaming, durable, same-directory saves only)
    writes a **delta-only** checkpoint, the ``_INC_STORE_FIELDS`` tensors
    plus the WAL position, whose manifest chains back to the newest full
    snapshot; see ``SearchEngine.save``. Each incremental carries the
    *complete current* delta / tombstone / id-map state, so the newest
    link supersedes the older ones: loading reads exactly two files (base
    + newest incremental). The chained base pins the WAL truncation floor:
    a follower seeded from the base artifact still needs every record past
    the base's ``wal_seq``.
    """
    if incremental:
        return _save_incremental(engine, directory)
    streaming = engine.store is not None
    if not streaming and engine.state is None:
        raise RuntimeError(
            "nothing to save: the dense EngineState was freed by "
            "shard(donate=True); call save() before donating the dense "
            "tensors")
    if streaming and engine._compact_future is not None:
        engine.finish_compact()      # snapshot the post-swap store
    wal = None
    wal_seq = -1
    if (engine._wal is not None
            and os.path.abspath(directory) == engine._durable_dir):
        wal = engine._wal
        wal.sync()                   # everything the snapshot covers is on
        wal_seq = wal.last_seq       # disk before the snapshot claims it
    elif engine._wal is not None:
        # a foreign-directory snapshot of a durable primary: record the
        # WAL position anyway, the seed point of a follower built from it
        engine._wal.sync()
        wal_seq = engine._wal.last_seq
    elif engine._role == "follower":
        wal_seq = engine._applied_seq    # a follower's position is its
        #                                  applied seq, not a local log
    flat_alias = False
    store_fields = []
    if streaming:
        frozen = engine.frozen._replace(proj=_raw_proj(engine.frozen.proj))
        tree = {"store": engine.store, "frozen": frozen}
        store_fields = [f for f in _OPT_STORE_FIELDS
                        if getattr(engine.store, f) is not None]
    else:
        state = engine.state._replace(proj=_raw_proj(engine.state.proj))
        if state.index.kind == "flat" and state.index.payload is state.corpus:
            # don't write the same rows twice; restore re-aliases
            flat_alias = True
            state = state._replace(index=Index("flat", None))
        tree = {"state": state}
    # fresh step per save: the metadata names its checkpoint, so a crash
    # between the array write and the metadata commit leaves the previous
    # (still named, still retained) snapshot intact
    path = save_arrays(directory, _next_step(directory), _arrays(tree),
                       protect=sorted(_prior_chain(directory)))
    engine._crash("snapshot_arrays")
    if wal is not None:
        # the mark is itself covered by wal_seq: a no-op on replay, so
        # writing it before the metadata commit is safe either way the
        # commit goes, and afterwards replay starts strictly past it
        wal_seq = wal.append(RT_SNAPSHOT, str(wal_seq).encode())
        wal.sync()
    chain = [os.path.basename(path)]
    _commit_meta(directory, _meta(
        engine, path, streaming=streaming, flat_alias=flat_alias,
        store_fields=store_fields, wal_seq=wal_seq, durable=wal is not None,
        incremental=False, chain=chain))
    engine._crash("snapshot_commit")
    if wal is not None:
        # snapshot durable: records at or before wal_seq are dead weight,
        # and this full snapshot is the new chain base: the floor moves
        wal.pin_floor(wal_seq)
        wal.truncate(wal_seq)
    if streaming:
        engine._base_ref = {"dir": os.path.abspath(directory),
                            "ckpt": chain[0], "wal_seq": wal_seq,
                            "chain": chain}
        engine._base_dirty = False
    engine._snap_counters["full"] += 1
    engine._snap_counters["last_bytes"] = os.path.getsize(path)
    engine._snap_counters["chain_depth"] = 0
    return path


def _save_incremental(engine: SearchEngine, directory: str) -> str:
    """The delta-only save (``save_engine(..., incremental=True)``):
    checks the chain's invariants, writes only the ``_INC_STORE_FIELDS``
    tensors and commits a manifest chained to the existing base."""
    directory_abs = os.path.abspath(directory)
    if engine.store is None:
        raise ValueError(
            "incremental snapshots cover the streaming delta state; this "
            "engine is read-only, so its one full snapshot already is "
            "minimal. Use engine.save(dir).")
    if engine._compact_future is not None:
        engine.finish_compact()      # lands base changes -> dirties base
    if engine._wal is None or engine._durable_dir != directory_abs:
        raise ValueError(
            "incremental save needs a durable base: the chain's WAL "
            "position only means something against the log in the same "
            "directory. Call engine.durable(dir) (which takes the full "
            "base snapshot) and then save(dir, incremental=True).")
    base = engine._base_ref
    if base is None or base["dir"] != directory_abs:
        raise ValueError(
            "incremental save without a base snapshot in this directory: "
            "call engine.save(dir) once (full) before chaining "
            "incrementals onto it.")
    if engine._base_dirty:
        raise ValueError(
            "the base tensors changed since the base snapshot (a "
            "compaction, vacuum, rebuild or grow rewrote them), so a "
            "delta-only snapshot can no longer restore this engine: "
            "take a full snapshot (engine.save(dir)) to start a new "
            "chain.")
    if not os.path.isfile(os.path.join(directory, base["ckpt"])):
        raise FileNotFoundError(
            f"the chain's base checkpoint {base['ckpt']!r} is gone from "
            f"{directory!r}; take a full snapshot to start a new chain")
    wal = engine._wal
    wal.sync()
    wal_seq = wal.last_seq
    arrays = {key: arr for key, arr in _arrays({"store": engine.store}).items()
              if key.rsplit(".", 1)[-1] in _INC_STORE_FIELDS}
    protect = set(base["chain"]) | {base["ckpt"]}
    path = save_arrays(directory, _next_step(directory), arrays,
                       protect=sorted(protect))
    engine._crash("snapshot_arrays")
    wal_seq = wal.append(RT_SNAPSHOT, str(wal_seq).encode())
    wal.sync()
    chain = list(base["chain"]) + [os.path.basename(path)]
    _commit_meta(directory, _meta(
        engine, path, streaming=True, flat_alias=False,
        store_fields=[f for f in _OPT_STORE_FIELDS
                      if getattr(engine.store, f) is not None],
        wal_seq=wal_seq, durable=True, incremental=True,
        base_ckpt=base["ckpt"], base_wal_seq=base["wal_seq"], chain=chain))
    engine._crash("snapshot_commit")
    # records past the BASE's position must survive truncation: they are
    # what re-seeds a follower built from the base artifact (and what a
    # re-resolved chain replays past the newest incremental)
    wal.pin_floor(base["wal_seq"])
    wal.truncate(wal_seq)
    engine._base_ref = dict(base, chain=chain)
    engine._snap_counters["incremental"] += 1
    engine._snap_counters["last_bytes"] = os.path.getsize(path)
    engine._snap_counters["chain_depth"] = len(chain) - 1
    return path


def _read_arrays(path: str, overlay: Optional[str]) -> dict:
    """Every array of the checkpoint ``path``; an ``overlay`` checkpoint's
    arrays win for the keys it holds."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    if overlay is not None:
        with np.load(overlay) as data:
            arrays.update({k: data[k] for k in data.files})
    return arrays


def load_engine(directory: str, mesh=None, axis: str = "data",
                role: str = "primary", *, device: DeviceLike = None,
                **runtime_overrides) -> SearchEngine:
    """Restore a ``save_engine`` snapshot (the port's or the JAX
    package's) into a serving ``SearchEngine`` on ``device`` (``cuda``
    unless told otherwise).

    The spec string in ``engine.json`` rebuilds the config; the tensors
    come back with the shapes and dtypes the engine had. An incremental
    manifest resolves its chain: base tensors from the referenced full
    checkpoint, delta / tombstone / id-map tensors from the newest
    incremental. ``runtime_overrides`` replace persisted runtime knobs
    (``query_bucket=...``, ...); ``stream=`` is refused (its capacities
    are the saved tensors' shapes).

    ``mesh`` (a ``repro_torch.parallel.Mesh``; ``device`` defaults to its
    device) restores onto a serving mesh: the engine comes back whole on
    this rank, then ``shard(mesh, axis=axis)`` keeps its slice, freeing
    the dense copy of a read-only engine (``donate=True``); a streaming
    engine shards its base and keeps the replicated write path. Every
    rank of the mesh makes the same call.

    ``role="follower"`` builds a read replica: the snapshot's tensors and
    WAL *position* are restored, but the local log is neither replayed
    nor resumed (the directory may be a shipped copy; a follower's
    history comes from its primary through
    ``durability.replication.catch_up``). Follower engines refuse local
    writes. Otherwise a durable snapshot is recovered: the WAL's tail is
    replayed and the engine resumes appending to the same log.
    """
    if mesh is not None and device is None:
        device = mesh.device
    if role not in ("primary", "follower"):
        raise ValueError(
            f"unknown role {role!r}; expected 'primary' or 'follower'")
    from repro_torch.bridge import state_from_arrays, stream_from_arrays

    meta_path = os.path.join(directory, SNAPSHOT_META)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"no engine snapshot at {directory!r} (missing {SNAPSHOT_META})")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("schema") != _SCHEMA:
        raise ValueError(
            f"unknown snapshot schema {meta.get('schema')!r} in {meta_path}")
    if meta.get("ckpt"):
        # the metadata names its checkpoint: immune to a stray newer file
        # whose metadata commit never happened (a crash mid-save)
        path = os.path.join(directory, meta["ckpt"])
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"snapshot metadata names missing checkpoint {path!r}")
    else:
        path = latest_checkpoint(directory)
        if path is None:
            raise FileNotFoundError(f"no checkpoint file in {directory!r}")
    overlay = None
    if meta.get("incremental"):
        # chain resolution: the named ckpt is delta-only; the base holds
        # everything else. The newest incremental supersedes older links.
        overlay = path
        path = os.path.join(directory, meta["base_ckpt"])
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"incremental snapshot chain is broken: base checkpoint "
                f"{meta['base_ckpt']!r} is missing from {directory!r} "
                f"(chain {meta.get('chain')}); re-seed from a full "
                "snapshot")
    spec = parse_spec(meta["spec"])
    if "stream" in runtime_overrides:
        raise ValueError(
            "stream= cannot be overridden at load: the StreamConfig's "
            "capacities are baked into the saved store's shapes; restore, "
            "then compact or rebuild to re-provision")
    runtime = {k: v for k, v in meta["runtime"].items()
               if k not in _NO_COUNTERPART}
    if meta["stream"] is not None:
        skw = dict(meta["stream"])
        if skw.get("policy") is not None:
            skw["policy"] = PolicyConfig(**skw["policy"])
        runtime["stream"] = StreamConfig(**skw)
    runtime.update(runtime_overrides)
    config = config_from_spec(spec, **runtime)
    arrays = _read_arrays(path, overlay)
    if meta["streaming"]:
        store, frozen = stream_from_arrays(arrays, spec, device)
        engine = SearchEngine._restore(config, store=store, frozen=frozen)
    else:
        engine = SearchEngine._restore(
            config, state=state_from_arrays(arrays, spec, device))
    del arrays
    wal_seq = meta.get("wal_seq", -1)
    engine._applied_seq = wal_seq
    if meta["streaming"]:
        # the loaded manifest's chain is the one this engine may extend
        # with save(dir, incremental=True)
        engine._base_ref = {
            "dir": os.path.abspath(directory),
            "ckpt": meta.get("base_ckpt") or meta["ckpt"],
            "wal_seq": (meta.get("base_wal_seq", wal_seq)
                        if meta.get("incremental") else wal_seq),
            "chain": list(meta.get("chain") or [meta["ckpt"]]),
        }
        engine._snap_counters["chain_depth"] = (
            len(engine._base_ref["chain"]) - 1)
    if role == "follower":
        # a replica: position only; no local replay (the shipped history
        # comes from the primary through catch_up), no local WAL writer
        engine._role = "follower"
    elif meta.get("durability") is not None:
        # crash recovery: replay the WAL's tail (records after the saved
        # sequence) through the engine's own write methods, then resume
        # appending to the same log
        from .durability.recovery import replay
        dcfg = DurabilityConfig(**meta["durability"])
        wal_dir = os.path.join(directory, "wal")
        stats = replay(engine, wal_dir, after_seq=wal_seq)
        engine._replayed = stats.records
        if stats.records:
            engine._applied_seq = stats.last_seq
        engine._wal = Wal(wal_dir, dcfg, resume=True)
        engine._durability = dcfg
        engine._durable_dir = os.path.abspath(directory)
        if meta["streaming"]:
            # the floor pin is engine state, not log state: re-pin from
            # the manifest so chained truncation holds past a restart
            engine._wal.pin_floor(engine._base_ref["wal_seq"])
    if mesh is not None:
        engine.shard(mesh, axis=axis, donate=not meta["streaming"])
    return engine
