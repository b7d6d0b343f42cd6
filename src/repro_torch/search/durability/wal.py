"""Write-ahead log: CRC-framed, fsync-configurable, segment-rotated (port
of ``repro.search.durability.wal``; the bytes on disk are the JAX
package's, so either package reads the other's log).

The durable-streaming contract (see ``repro_torch.search.serve.
SearchEngine.durable``): every mutation of the ``StreamStore`` appends
one record here *before* it touches the store, in mutation order, so the
byte stream is a deterministic replay script. ``load_engine`` replays the
tail (records past the snapshot's ``wal_seq``) through the engine's own
write methods and arrives at the store of the engine that never crashed.

Record framing (little-endian)::

    [crc32 u32][payload_len u32][seq u64][rtype u8][payload ...]

The CRC covers (payload_len, seq, rtype, payload). ``seq`` is a global
monotonically increasing record number; segment files are named
``wal-<firstseq>.log`` after the first record they hold, so truncating
history older than a durable snapshot is unlinking whole files.

Record types::

    RT_UPSERT    ids + vectors of one engine write chunk
    RT_DELETE    ids of one delete batch
    RT_COMPACT   compaction barrier (logged when compaction BEGINS;
                 replay redoes the fold, so a crash mid-compaction
                 recovers to the completed-compaction state)
    RT_SNAPSHOT  durable-snapshot mark (records at or before the seq in
                 ``engine.json`` are dead weight and get truncated)
    RT_POLICY    a MaintenancePolicy decision (JSON): vacuum / grow /
                 rebuild are replayed deterministically from the log

Ids travel as int32, as the JAX package writes them; the port's ids are
int64, so a durable engine refuses an id outside the int32 range
(``check_ids``) rather than truncate it.

Torn tails: a crash mid-append leaves a half frame (or a frame whose CRC
fails) at the end of the *last* segment; readers stop there, and resuming
a writer truncates the torn bytes first. The same damage anywhere else is
real corruption and raises ``WalError``.

Fsync modes (``DurabilityConfig.fsync``): ``"always"`` fsyncs per record
(strict durability), ``"batch"`` flushes per record to the OS and fsyncs
at rotation, snapshot and close (safe against a process crash; a power
loss can drop the page cache), ``"never"`` leaves flushing to the runtime
(bulk loads).

Group commit (``DurabilityConfig.group_commit_ms > 0``, requires
``fsync="always"``): appends enqueue onto a dedicated commit thread that
coalesces every record written while the previous fsync was in flight,
plus a bounded ``group_commit_ms`` gathering window, into ONE fsync.
``append`` still returns only after its covering sync; concurrent
writers share the disk flush instead of paying one fsync each.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import time
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["DurabilityConfig", "Wal", "WalError",
           "RT_UPSERT", "RT_DELETE", "RT_COMPACT", "RT_SNAPSHOT",
           "RT_POLICY",
           "encode_upsert", "decode_upsert", "encode_delete",
           "decode_delete", "encode_policy", "decode_policy", "check_ids",
           "iter_frames", "iter_records", "wal_tail_seq"]

RT_UPSERT = 1
RT_DELETE = 2
RT_COMPACT = 3
RT_SNAPSHOT = 4
RT_POLICY = 5

_MAGIC = b"QPADWAL1"
_HEAD = struct.Struct("<IQB")        # payload_len, seq, rtype (crc'd part)
_CRC = struct.Struct("<I")
_FRAME_MIN = _CRC.size + _HEAD.size
_UPS_HDR = struct.Struct("<II")      # batch, dim

_FSYNC_MODES = ("always", "batch", "never")
_ROLES = ("primary", "follower")


class WalError(RuntimeError):
    """Unrecoverable log damage: a bad frame *before* the tail of the
    last segment (torn tails are expected and handled; this is not)."""


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """Write-ahead-log + replication-role knobs (``SearchEngine.durable``).

    ``role`` declares what this node is: a ``"primary"`` owns a local
    WAL and accepts writes; a ``"follower"`` tails a primary's shipped
    log (``repro_torch.search.durability.replication``) and never opens a
    local WAL — ``SearchEngine.durable`` rejects the combination.
    ``group_commit_ms`` > 0 turns on group commit (see module docs);
    it bounds the extra latency one append may wait to share its fsync
    with neighbors, and only makes sense under ``fsync="always"`` —
    the other modes never fsync per record, so there is nothing to
    coalesce and the config is rejected as incoherent.
    """
    fsync: str = "batch"             # "always" | "batch" | "never"
    segment_bytes: int = 4 * 1024 * 1024   # rotate segments near this size
    role: str = "primary"            # "primary" | "follower"
    group_commit_ms: float = 0.0     # > 0: coalesce fsyncs (fsync="always")

    def __post_init__(self):
        if self.fsync not in _FSYNC_MODES:
            raise ValueError(
                f"unknown fsync mode {self.fsync!r}; expected one of "
                f"{_FSYNC_MODES}")
        if self.segment_bytes < len(_MAGIC) + _FRAME_MIN:
            raise ValueError("segment_bytes too small to hold one record")
        if self.role not in _ROLES:
            raise ValueError(
                f"unknown role {self.role!r}; expected one of {_ROLES}")
        if self.group_commit_ms < 0:
            raise ValueError("group_commit_ms must be >= 0")
        if self.group_commit_ms > 0 and self.fsync != "always":
            raise ValueError(
                f"group_commit_ms={self.group_commit_ms} is incoherent with "
                f"fsync={self.fsync!r}: group commit coalesces the per-record "
                "fsyncs of fsync='always'; the other modes never fsync per "
                "record. Use DurabilityConfig(fsync='always', "
                "group_commit_ms=...) or drop group_commit_ms.")


# --- record payload codecs ---------------------------------------------------

_I32 = np.iinfo(np.int32)


def check_ids(ids) -> np.ndarray:
    """``ids`` as an int32 array for a record, or ``ValueError`` when one
    lies outside the int32 range (the log's id width): never truncated."""
    ids = np.asarray(ids).reshape(-1)
    if ids.size and (ids.min() < _I32.min or ids.max() > _I32.max):
        bad = ids[(ids < _I32.min) | (ids > _I32.max)][0]
        raise ValueError(
            f"id {int(bad)} is outside the int32 range the write-ahead "
            "log stores ids in; a durable engine takes ids in "
            f"[{_I32.min}, {_I32.max}]")
    return ids.astype(np.int32)


def encode_upsert(ids, vectors) -> bytes:
    """(B,) ids in the int32 range + (B, D) f32 vectors -> one RT_UPSERT
    payload."""
    ids = np.ascontiguousarray(check_ids(ids))
    vectors = np.ascontiguousarray(vectors, np.float32)
    b, d = vectors.shape
    return (_UPS_HDR.pack(b, d) + ids.tobytes() + vectors.tobytes())


def decode_upsert(payload: bytes):
    """RT_UPSERT payload -> (ids (B,) int32, vectors (B, D) f32)."""
    b, d = _UPS_HDR.unpack_from(payload)
    off = _UPS_HDR.size
    ids = np.frombuffer(payload, np.int32, count=b, offset=off)
    vecs = np.frombuffer(payload, np.float32, count=b * d,
                         offset=off + 4 * b).reshape(b, d)
    return ids, vecs


def encode_delete(ids) -> bytes:
    """(B,) ids in the int32 range -> one RT_DELETE payload."""
    return np.ascontiguousarray(check_ids(ids)).tobytes()


def decode_delete(payload: bytes) -> np.ndarray:
    """RT_DELETE payload -> (B,) int32 ids."""
    return np.frombuffer(payload, np.int32)


def encode_policy(decision: dict) -> bytes:
    """A MaintenancePolicy decision -> one RT_POLICY payload (JSON)."""
    return json.dumps(decision, sort_keys=True).encode()


def decode_policy(payload: bytes) -> dict:
    """RT_POLICY payload -> the decision dict."""
    return json.loads(payload.decode())


# --- segment reading ---------------------------------------------------------

def _segment_first_seq(name: str) -> Optional[int]:
    if not (name.startswith("wal-") and name.endswith(".log")):
        return None
    try:
        return int(name[4:-4])
    except ValueError:
        return None


def _list_segments(directory: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    segs = []
    for name in os.listdir(directory):
        first = _segment_first_seq(name)
        if first is not None:
            segs.append((first, os.path.join(directory, name)))
    return sorted(segs)


def iter_frames(data: bytes, *, is_last: bool, name: str = "<bytes>"):
    """Yield (seq, rtype, payload, end_offset) frames of one segment's
    bytes — the shared parser under local recovery (``_read_segment``)
    and WAL shipping (a transport fetches segment *bytes*; the follower
    parses them with exactly the reader the primary would use).

    A bad/half frame ends iteration when ``is_last`` (torn tail, the
    expected crash artifact) and raises ``WalError`` otherwise.
    """
    if data[:len(_MAGIC)] != _MAGIC:
        raise WalError(f"bad segment magic in {name!r}")
    off = len(_MAGIC)
    while off < len(data):
        frame_ok = False
        if off + _FRAME_MIN <= len(data):
            (crc,) = _CRC.unpack_from(data, off)
            head = data[off + _CRC.size: off + _FRAME_MIN]
            plen, seq, rtype = _HEAD.unpack(head)
            end = off + _FRAME_MIN + plen
            if end <= len(data):
                payload = data[off + _FRAME_MIN: end]
                frame_ok = zlib.crc32(head + payload) == crc
        if not frame_ok:
            if is_last:
                return                      # torn tail: stop at last good
            raise WalError(
                f"corrupt WAL frame at {name!r}+{off} (not the log tail)")
        yield seq, rtype, payload, end
        off = end


def _read_segment(path: str, *, is_last: bool):
    """``iter_frames`` over one on-disk segment file."""
    with open(path, "rb") as f:
        data = f.read()
    yield from iter_frames(data, is_last=is_last, name=path)


def iter_records(directory: str, after: int = -1
                 ) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (seq, rtype, payload) for every record with ``seq > after``,
    in order, across segments; stops cleanly at a torn tail."""
    segs = _list_segments(directory)
    for i, (first, path) in enumerate(segs):
        nxt = segs[i + 1][0] if i + 1 < len(segs) else None
        if nxt is not None and nxt - 1 <= after:
            continue                        # fully covered by the snapshot
        for seq, rtype, payload, _ in _read_segment(
                path, is_last=(i == len(segs) - 1)):
            if seq > after:
                yield seq, rtype, payload


def wal_tail_seq(directory: str) -> int:
    """Seq of the last intact record on disk (-1 = empty/absent log)."""
    last = -1
    for seq, _, _ in iter_records(directory):
        last = seq
    return last


# --- the writer --------------------------------------------------------------

class Wal:
    """Append-only writer over a directory of CRC-framed segments.

    ``resume=True`` scans the existing log, truncates a torn tail, and
    continues the sequence; the default refuses a non-empty directory
    (recover through ``load_engine`` instead of silently forking
    history). Counters (records/bytes/fsyncs/rotations/group_commits)
    are in ``stats()``.

    The writer is thread-safe: concurrent ``append`` calls serialize on
    an internal lock, and with ``group_commit_ms`` > 0 they share fsyncs
    through the commit thread instead of each paying one.

    ``floor_seq``: chained incremental snapshots reference a *base*
    manifest whose WAL position pins how far history may be truncated —
    a follower re-seeded from the base artifact still needs every record
    past the base's ``wal_seq``. ``pin_floor`` records that bound and
    ``truncate`` clamps to it.
    """

    def __init__(self, directory: str, config: DurabilityConfig = None, *,
                 resume: bool = False):
        self.directory = directory
        self.config = config or DurabilityConfig()
        self.counters = {"records": 0, "bytes": 0, "fsyncs": 0,
                         "rotations": 0, "group_commits": 0}
        self.last_seq = -1
        self.floor_seq: Optional[int] = None
        self._f = None
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._durable_seq = -1          # group mode: last fsync-covered seq
        self._closing = False
        self._committer: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        segs = _list_segments(directory)
        if segs and not resume:
            raise RuntimeError(
                f"WAL directory {directory!r} already holds segments; "
                "re-open the engine with load_engine (which replays and "
                "resumes) instead of starting a second history")
        if segs:
            self._resume(segs)
        else:
            self._open_segment(0)
        self._durable_seq = self.last_seq
        if self.config.group_commit_ms > 0:
            self._committer = threading.Thread(
                target=self._commit_loop, name="wal-group-commit",
                daemon=True)
            self._committer.start()

    @property
    def _grouped(self) -> bool:
        return self._committer is not None

    def _resume(self, segs):
        first, path = segs[-1]
        end = len(_MAGIC)
        for seq, _, _, off in _read_segment(path, is_last=True):
            self.last_seq = seq
            end = off
        for f_seq, p in segs[:-1]:
            for seq, _, _, _ in _read_segment(p, is_last=False):
                self.last_seq = max(self.last_seq, seq)
        if self.last_seq < 0 and len(segs) > 1:
            self.last_seq = first - 1
        self._f = open(path, "r+b")
        self._f.truncate(end)               # drop the torn tail for good
        self._f.seek(end)
        self._path = path

    def _open_segment(self, first_seq: int):
        path = os.path.join(self.directory, f"wal-{first_seq:016d}.log")
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._path = path

    def _sync_file(self):
        self._f.flush()
        os.fsync(self._f.fileno())
        self.counters["fsyncs"] += 1

    def _commit_loop(self):
        """Group-commit thread: one fsync covers every record appended
        before it runs (records keep arriving while the previous fsync
        is in flight — that disk time IS the natural batching window;
        ``group_commit_ms`` adds a bounded extra gather)."""
        window_s = self.config.group_commit_ms / 1e3
        while True:
            with self._cv:
                while self.last_seq <= self._durable_seq and not self._closing:
                    self._cv.wait()
                if self._f is None or (self._closing
                                       and self.last_seq <= self._durable_seq):
                    self._cv.notify_all()
                    return
            if window_s > 0 and not self._closing:
                time.sleep(window_s)        # bounded coalescing wait
            with self._cv:
                if self._f is None:
                    self._cv.notify_all()
                    return
                target = self.last_seq
                if target > self._durable_seq:
                    self._sync_file()
                    self.counters["group_commits"] += 1
                    self._durable_seq = target
                self._cv.notify_all()

    def append(self, rtype: int, payload: bytes = b"", *,
               wait: bool = True) -> int:
        """Append one record; returns its seq. Durability per the
        configured fsync mode; under group commit the call returns after
        the fsync covering this record (``wait=False`` defers that to a
        later ``wait_durable`` — for multi-record batches that only need
        one durability point at the end)."""
        with self._cv:
            if self._f is None:
                raise RuntimeError("WAL is closed")
            seq = self.last_seq + 1
            head = _HEAD.pack(len(payload), seq, rtype)
            frame = _CRC.pack(zlib.crc32(head + payload)) + head + payload
            if (self._f.tell() + len(frame) > self.config.segment_bytes
                    and self._f.tell() > len(_MAGIC)):
                self._sync_file()
                self._f.close()
                self._open_segment(seq)
                self.counters["rotations"] += 1
                self._durable_seq = seq - 1   # rotation synced everything
            self._f.write(frame)
            if self.config.fsync == "always":
                if self._grouped:
                    # Make the bytes visible to same-host readers now;
                    # the commit thread owns the (expensive) fsync.
                    self._f.flush()
                    self._cv.notify_all()
                else:
                    self._sync_file()
                    self._durable_seq = seq
            elif self.config.fsync == "batch":
                self._f.flush()
            self.last_seq = seq
            self.counters["records"] += 1
            self.counters["bytes"] += len(frame)
        if wait:
            self.wait_durable(seq)
        return seq

    def wait_durable(self, seq: Optional[int] = None):
        """Block until record ``seq`` (default: the last appended) is
        covered by an fsync. No-op outside group-commit mode — the other
        fsync modes resolve durability inside ``append`` itself."""
        if not self._grouped:
            return
        with self._cv:
            target = self.last_seq if seq is None else seq
            while self._durable_seq < target and self._f is not None:
                self._cv.wait(timeout=1.0)

    def sync(self):
        """Force the appended records to disk (snapshot barrier)."""
        with self._cv:
            if self._f is not None:
                self._sync_file()
                self._durable_seq = self.last_seq
                self._cv.notify_all()

    def pin_floor(self, seq: Optional[int]):
        """Pin the truncation floor: records with ``seq > floor`` must
        stay on disk (the newest *base* snapshot manifest still
        references them). ``None`` lifts the pin."""
        self.floor_seq = seq

    def truncate(self, upto_seq: int):
        """Unlink segments whose every record has ``seq <= upto_seq``
        (history covered by a durable snapshot), clamped to the pinned
        ``floor_seq``. The open segment always survives."""
        if self.floor_seq is not None:
            upto_seq = min(upto_seq, self.floor_seq)
        with self._mu:
            segs = _list_segments(self.directory)
            for i, (first, path) in enumerate(segs):
                nxt = segs[i + 1][0] if i + 1 < len(segs) else None
                if (path != self._path and nxt is not None
                        and nxt - 1 <= upto_seq):
                    os.unlink(path)

    def close(self):
        if self._committer is not None:
            with self._cv:
                self._closing = True
                self._cv.notify_all()
            self._committer.join()
            self._committer = None
        with self._cv:
            if self._f is not None:
                if self.config.fsync != "never":
                    self._sync_file()
                    self._durable_seq = self.last_seq
                self._f.close()
                self._f = None
            self._cv.notify_all()

    def stats(self) -> dict:
        """Counters and positions (the JAX package's
        ``SearchEngine.metrics()`` reads the same dict)."""
        return dict(self.counters, last_seq=self.last_seq,
                    durable_seq=self._durable_seq,
                    floor_seq=-1 if self.floor_seq is None else self.floor_seq,
                    segments=len(_list_segments(self.directory)),
                    fsync=self.config.fsync,
                    group_commit_ms=self.config.group_commit_ms)
