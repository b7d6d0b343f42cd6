"""WAL shipping and follower catch-up: read replicas without rebuilds
(port of ``repro.search.durability.replication``).

The replication contract extends the single-node durability contract
(``wal.py``): the primary's WAL is a deterministic replay script, so a
follower that (a) restores *any* snapshot of the primary and (b) applies
every shipped record past that snapshot's ``wal_seq`` through the same
``replay_records`` is equal to the primary record for record, across
compaction / vacuum / rebuild barriers too, which the follower re-folds
from the logged RT_COMPACT / RT_POLICY records with its own
(deterministic, seeded) write path. Folded arrays never cross the wire;
only log records move.

Transports: a source is anything with the three-method ``WalSource``
shape: list segments, fetch one segment's bytes, report the tail seq.
``LocalDirSource`` (shared filesystem or an rsync'd directory) is the
bundled implementation; a network transport implements the same
interface.

Divergence: ``catch_up`` demands strict seq contiguity from the shipped
stream. A gap (the primary truncated history past the follower's
position) or a CRC failure mid-stream (a damaged shipment) raises
``DivergenceError``: the follower cannot rejoin by tailing and must be
re-seeded from a fresh snapshot (``engine.save(dir, incremental=True)``
is the cheap re-seed artifact). A torn tail on the *last* shipped
segment is not divergence: it is the primary's in-flight append, and the
next ``catch_up`` picks it up.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterator, List, Protocol, Tuple

from .recovery import ReplayStats, replay_records
from .wal import WalError, _list_segments, _segment_first_seq, iter_frames

__all__ = ["ReplicationError", "DivergenceError", "WalSource",
           "LocalDirSource", "CatchUpStats", "catch_up", "seed_follower"]


class ReplicationError(RuntimeError):
    """Replication misuse or transport failure (not history damage)."""


class DivergenceError(ReplicationError):
    """The follower's position and the source's history no longer form
    one line: a seq gap (history truncated past the follower) or a CRC
    failure mid-stream. Tailing cannot recover this — re-seed the
    follower from a fresh primary snapshot."""


class WalSource(Protocol):
    """What a WAL-shipping transport must provide. ``LocalDirSource``
    reads a directory; a network transport implements the same calls."""

    def segments(self) -> List[Tuple[int, str]]:
        """Sorted (first_seq, name) of the available segments."""
        ...

    def fetch(self, name: str) -> bytes:
        """One segment's bytes, verbatim."""
        ...

    def tail_seq(self) -> int:
        """Seq of the source's last intact record (-1 = empty)."""
        ...


class LocalDirSource:
    """``WalSource`` over a local/shared filesystem directory — the
    primary's live ``<durable_dir>/wal`` or any rsync'd copy of it.
    Accepts either the WAL directory itself or the durable directory
    containing a ``wal/`` subdirectory."""

    def __init__(self, directory: str):
        wal_sub = os.path.join(directory, "wal")
        self.directory = wal_sub if os.path.isdir(wal_sub) else directory

    def segments(self) -> List[Tuple[int, str]]:
        return [(first, os.path.basename(path))
                for first, path in _list_segments(self.directory)]

    def fetch(self, name: str) -> bytes:
        if _segment_first_seq(name) is None:
            raise ReplicationError(f"not a WAL segment name: {name!r}")
        with open(os.path.join(self.directory, name), "rb") as f:
            return f.read()

    def tail_seq(self) -> int:
        last = -1
        for seq, _, _ in _iter_source_records(self, after=-1):
            last = seq
        return last


def _iter_source_records(source: WalSource, after: int
                         ) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (seq, rtype, payload) with ``seq > after`` from a source's
    shipped segments — the transport-side mirror of ``iter_records``.
    Stops cleanly at a torn tail on the last segment; mid-stream damage
    raises ``WalError`` (wrapped into ``DivergenceError`` by
    ``catch_up``)."""
    segs = source.segments()
    for i, (first, name) in enumerate(segs):
        nxt = segs[i + 1][0] if i + 1 < len(segs) else None
        if nxt is not None and nxt - 1 <= after:
            continue                       # fully behind the follower
        data = source.fetch(name)
        for seq, rtype, payload, _ in iter_frames(
                data, is_last=(i == len(segs) - 1), name=name):
            if seq > after:
                yield seq, rtype, payload


@dataclasses.dataclass
class CatchUpStats:
    """What one ``catch_up`` pass shipped and applied."""
    records: int = 0
    upserts: int = 0
    deletes: int = 0
    compactions: int = 0
    policies: int = 0
    rows: int = 0
    applied_seq: int = -1            # follower position after the pass
    source_tail_seq: int = -1        # primary position when we looked
    lag_seq: int = 0                 # source_tail - applied (0 = caught up)


def _contiguous(records, start_after: int, available_floor):
    """Pass records through while enforcing seq == prev + 1; a gap means
    the source truncated history past the follower's position."""
    expected = start_after + 1
    for seq, rtype, payload in records:
        if seq != expected:
            raise DivergenceError(
                f"seq gap in shipped WAL: follower is at seq "
                f"{expected - 1} but the next available record is seq "
                f"{seq} (source history starts at segment seq "
                f"{available_floor}). The primary truncated past this "
                "follower; re-seed it from a fresh primary snapshot "
                "(engine.save(dir) or save(dir, incremental=True)) and "
                "catch_up again.")
        yield seq, rtype, payload
        expected = seq + 1


def catch_up(engine, source: WalSource, after_seq: int = None
             ) -> CatchUpStats:
    """Tail the primary's shipped WAL into a follower engine.

    ``engine`` is a streaming ``SearchEngine`` seeded from any primary
    snapshot (``seed_follower`` / ``load_engine(..., role="follower")``);
    ``source`` is the transport over the primary's log. Applies every
    record past ``after_seq`` (default: the follower's tracked
    ``applied_seq``) through the engine's own write methods, then
    advances the follower's position. Incremental and repeatable — call
    it on a schedule; a pass that finds nothing new is a cheap no-op.

    Raises ``DivergenceError`` on a seq gap or mid-stream CRC failure
    (re-seed the follower), ``ReplicationError`` on misuse (the engine
    owns a WAL, i.e. it is a primary — a node cannot be both).
    """
    if engine.store is None:
        raise ReplicationError(
            "catch_up needs a streaming engine (the follower applies "
            "shipped records through its StreamStore write path); build "
            "it from a streaming snapshot of the primary")
    if engine._wal is not None:
        raise ReplicationError(
            "this engine owns a local WAL (it is a primary); a node "
            "cannot both accept local writes and tail another primary. "
            "Seed a follower with load_engine(snapshot_dir, "
            "role='follower') instead.")
    engine._role = "follower"
    after = engine._applied_seq if after_seq is None else after_seq
    segs = source.segments()
    available_floor = segs[0][0] if segs else 0
    stats = ReplayStats()
    try:
        replay_records(
            engine,
            _contiguous(_iter_source_records(source, after), after,
                        available_floor),
            stats)
        if stats.records:
            engine._applied_seq = stats.last_seq
        tail = source.tail_seq()     # may scan damage replay skipped over
    except WalError as e:
        raise DivergenceError(
            f"CRC failure in shipped WAL mid-stream ({e}); the shipment "
            "is damaged or the histories diverged. Re-seed the follower "
            "from a fresh primary snapshot and catch_up again.") from e
    if tail < engine._applied_seq:
        raise DivergenceError(
            f"follower is at seq {engine._applied_seq} but the source's "
            f"tail is seq {tail} — the source lost or rewound history "
            "(not the same primary, or its directory was reset). "
            "Re-seed the follower from a fresh primary snapshot.")
    engine._repl_catch_ups += 1
    engine._repl_records += stats.records
    engine._repl_source_tail = tail
    # wall-clock stamps for the replication metrics (the JAX package's
    # lag_seconds / catch_up_age_seconds): every pass refreshes the
    # staleness stamp, and a pass that drains the source pins the "fully
    # caught up" time
    engine._repl_last_catch_up_ts = time.time()
    if tail - engine._applied_seq <= 0:
        engine._repl_caught_up_ts = engine._repl_last_catch_up_ts
    return CatchUpStats(
        records=stats.records, upserts=stats.upserts, deletes=stats.deletes,
        compactions=stats.compactions, policies=stats.policies,
        rows=stats.rows, applied_seq=engine._applied_seq,
        source_tail_seq=tail, lag_seq=max(0, tail - engine._applied_seq))


def seed_follower(snapshot_dir: str, *, device=None, **runtime_overrides):
    """Build a follower from a primary snapshot directory: restores the
    arrays and the snapshot's WAL position, opens NO local WAL and
    replays NO local log (``catch_up`` ships the tail from the primary
    instead). Works off full and incremental (chained) snapshots alike.
    ``device`` as for ``load_engine`` (``cuda`` unless told otherwise).
    """
    from ..snapshot import load_engine          # lazy: avoid import cycle
    return load_engine(snapshot_dir, role="follower", device=device,
                       **runtime_overrides)
