"""Durability of a streaming engine: write-ahead log, crash recovery,
maintenance policy, replication (port of ``repro.search.durability``).

They wire through the engine's lifecycle
(``repro_torch.search.serve.SearchEngine``):

* ``wal``: the CRC-framed, fsync-configurable, segment-rotated record
  log every store mutation appends to *before* it runs
  (``engine.durable(dir)`` opens it; ``engine.save`` marks and
  truncates). Its bytes are the JAX package's.
* ``recovery``: ``load_engine`` replays the log tail on top of the
  newest durable snapshot through the engine's own write methods, so the
  recovered engine equals the one that never crashed, record for record.
* ``policy``: ``MaintenancePolicy`` watches tombstone density, delta
  fill, capacity headroom and PQ encode-error drift, and decides between
  compact / vacuum / grow / quantizer rebuild; the decisions are WAL
  records too, so recovery replays maintenance deterministically.
* ``replication``: WAL shipping. A primary's log segments move through a
  ``WalSource`` transport; a follower seeded from any snapshot calls
  ``catch_up`` repeatedly to tail them (divergence, a seq gap or a
  mid-stream CRC failure, raises ``DivergenceError``: re-seed).
"""
from .policy import Decision, MaintenancePolicy, PolicyConfig
from .recovery import ReplayStats, replay, replay_records
from .replication import (CatchUpStats, DivergenceError, LocalDirSource,
                          ReplicationError, WalSource, catch_up,
                          seed_follower)
from .wal import (DurabilityConfig, Wal, WalError, decode_delete,
                  decode_policy, decode_upsert, encode_delete, encode_policy,
                  encode_upsert, iter_frames, iter_records, wal_tail_seq)

__all__ = [
    "DurabilityConfig", "Wal", "WalError",
    "iter_frames", "iter_records", "wal_tail_seq",
    "encode_upsert", "decode_upsert", "encode_delete", "decode_delete",
    "encode_policy", "decode_policy",
    "PolicyConfig", "MaintenancePolicy", "Decision",
    "ReplayStats", "replay", "replay_records",
    "ReplicationError", "DivergenceError", "WalSource", "LocalDirSource",
    "CatchUpStats", "catch_up", "seed_follower",
]
