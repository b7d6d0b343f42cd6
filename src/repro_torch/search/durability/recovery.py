"""Crash recovery: replay the WAL tail through the engine's write path
(port of ``repro.search.durability.recovery``).

``load_engine`` restores the newest durable snapshot, then calls
``replay`` to drive every record past the snapshot's ``wal_seq`` back
through ``SearchEngine.upsert / delete / compact``, the write methods
live traffic uses, so the recovered store equals the one of the engine
that never crashed, tensor for tensor.

Replay runs with the engine's ``_replaying`` flag up: WAL appends, the
auto-compaction before a write and the policy's decisions are off (the
log already holds both the writes and the maintenance decisions;
re-deriving either would apply them twice), and a ``RT_COMPACT`` barrier,
logged when a compaction *begins*, is redone to completion, so a crash
mid-compaction recovers to the committed (post-swap) state.
"""
from __future__ import annotations

import dataclasses

from .wal import (RT_COMPACT, RT_DELETE, RT_POLICY, RT_SNAPSHOT, RT_UPSERT,
                  decode_delete, decode_policy, decode_upsert, iter_records)

__all__ = ["ReplayStats", "replay", "replay_records"]


@dataclasses.dataclass
class ReplayStats:
    """What one recovery pass applied (the engine keeps the record count
    as ``_replayed``)."""
    records: int = 0
    upserts: int = 0
    deletes: int = 0
    compactions: int = 0
    policies: int = 0
    rows: int = 0                    # upserted rows applied
    last_seq: int = -1


def replay_records(engine, records, stats: ReplayStats = None) -> ReplayStats:
    """Apply an ordered iterable of ``(seq, rtype, payload)`` records to
    ``engine`` — the shared apply loop under local crash recovery
    (records read from the engine's own WAL directory) and follower
    catch-up (records shipped from a primary through a transport).

    Runs with the engine's ``_replaying`` flag up: WAL appends and
    policy auto-decisions stay off, and RT_COMPACT / RT_POLICY barriers
    are re-folded through the engine's own write methods: a follower
    never copies folded arrays, it re-derives them deterministically.
    """
    stats = stats or ReplayStats()
    engine._replaying = True
    try:
        for seq, rtype, payload in records:
            # the decoded arrays are views of the read-only record: the
            # engine takes writable copies (torch refuses to wrap them)
            if rtype == RT_UPSERT:
                ids, vectors = decode_upsert(payload)
                engine.upsert(ids.copy(), vectors.copy())
                stats.upserts += 1
                stats.rows += int(ids.shape[0])
            elif rtype == RT_DELETE:
                engine.delete(decode_delete(payload).copy())
                stats.deletes += 1
            elif rtype == RT_COMPACT:
                engine.compact()
                stats.compactions += 1
            elif rtype == RT_POLICY:
                engine._apply_policy_record(decode_policy(payload))
                stats.policies += 1
            elif rtype == RT_SNAPSHOT:
                pass                 # marker only; truncation bookkeeping
            else:
                raise ValueError(f"unknown WAL record type {rtype}")
            stats.records += 1
            stats.last_seq = seq
    finally:
        engine._replaying = False
    return stats


def replay(engine, wal_dir: str, after_seq: int = -1) -> ReplayStats:
    """Apply every WAL record with ``seq > after_seq`` to ``engine``.

    ``engine`` is a streaming ``SearchEngine`` restored from the
    snapshot the log tail extends. Stops cleanly at a torn tail (the
    crash artifact); raises ``WalError`` on mid-log corruption.
    """
    stats = ReplayStats(last_seq=after_seq)
    return replay_records(engine, iter_records(wal_dir, after=after_seq),
                          stats)
