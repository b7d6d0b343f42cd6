"""Port parity for the durability stack (repro_torch.search.durability.wal
and recovery, and the SearchEngine's WAL wiring): twins of
tests/test_durability.py, held to the same contracts, and the port held
against the JAX package.

* **WAL framing**: records round-trip byte-exact across segment
  rotation; a torn tail is skipped by readers and truncated by a resuming
  writer; damage anywhere else raises ``WalError``; truncation unlinks only
  fully covered segments and keeps a pinned floor. The same records make
  the same segment bytes in both packages, and each reads the other's.
* **crash recovery**: a crash after any WAL record, or at each of the JAX
  package's lifecycle points (``crash_hook``), recovers through
  ``load_engine`` to the engine that never crashed, every store tensor
  equal. A log the JAX package wrote replays into the port with every
  store tensor equal to JAX's at every record boundary (ids as int32).
* **compaction and policy**: background compaction swaps atomically;
  deletes trigger vacuum through a configured policy; grows and rebuilds
  are WAL records and replay deterministically.

The port runs on the CPU (``device="cpu"``), its kernels' plain versions.
"""
import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.core.mpad import MPADConfig  # noqa: E402
from repro_torch.runtime.fault import FailureInjector  # noqa: E402
from repro_torch.search import (SearchEngine, ServeConfig,  # noqa: E402
                                StreamConfig, load_engine, rebuild_state,
                                search_fn)
from repro_torch.search.durability import (DurabilityConfig,  # noqa: E402
                                           PolicyConfig, Wal, WalError,
                                           replay_records, seed_follower)
from repro_torch.search.snapshot import snapshot_leaves  # noqa: E402
from repro_torch.search.durability.wal import (  # noqa: E402
    RT_COMPACT, RT_DELETE, RT_POLICY, RT_UPSERT, decode_delete,
    decode_policy, decode_upsert, encode_delete, encode_policy,
    encode_upsert, iter_records, wal_tail_seq)

N, DIM, K = 600, 32, 10
# float leaves the port computes itself (projections, bias terms): their
# sums run in another order than XLA's
COMPUTED = ("reduced", "delta_reduced", "bias", "bias_cell")


def _data(seed=0, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2
    lab = rng.integers(0, 12, n)
    return (centers[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _queries(nq=16):
    rng = np.random.default_rng(9)
    return (_data()[:nq] + 0.02 * rng.normal(size=(nq, DIM))).astype(
        np.float32)


def _cfg(index, target_dim=None, **stream_kw):
    stream_kw.setdefault("delta_capacity", 64)
    kw = dict(target_dim=target_dim, rerank=128, index=index,
              mpad=MPADConfig(m=8, iters=16) if target_dim else None,
              fit_sample=512, stream=StreamConfig(**stream_kw))
    if index in ("ivf", "ivfpq"):
        kw.update(nlist=12, nprobe=12)
    if index in ("pq", "ivfpq"):
        kw.update(pq_subspaces=8, pq_centroids=64)
    return ServeConfig(**kw)


def _engine(cfg):
    return SearchEngine(_data(), cfg, device="cpu")


def _rows(seed, n):
    return _data(seed=seed, n=n)


def _ids(eng, q):
    return eng.search(q, K)[1].numpy()


def _assert_same(a, b, where=""):
    """Every store tensor (and the frozen quantizers) of two engines
    equal: dtype and bits."""
    for f in a.store._fields:
        x, y = getattr(a.store, f), getattr(b.store, f)
        assert (x is None) == (y is None), (where, f)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), (where, f)
    fa, fb = snapshot_leaves(a.frozen), snapshot_leaves(b.frozen)
    assert [k for k, _ in fa] == [k for k, _ in fb], where
    for (key, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), (where, key)


# --- WAL unit layer ----------------------------------------------------------

def test_wal_roundtrip_and_rotation(tmp_path):
    """Records come back in order, byte-exact, across forced segment
    rotation; truncation after a snapshot unlinks only covered segments."""
    d = str(tmp_path / "wal")
    wal = Wal(d, DurabilityConfig(fsync="never", segment_bytes=256))
    payloads = []
    for i in range(30):
        p = encode_upsert(np.arange(i + 1, dtype=np.int32),
                          np.full((i + 1, 4), float(i), np.float32))
        payloads.append((RT_UPSERT, p))
        wal.append(RT_UPSERT, p)
    wal.append(RT_COMPACT, b"")
    payloads.append((RT_COMPACT, b""))
    wal.close()
    got = list(iter_records(d))
    assert [seq for seq, _, _ in got] == list(range(31))
    assert [(rt, pl) for _, rt, pl in got] == payloads
    segs = [f for f in os.listdir(d) if f.endswith(".log")]
    assert len(segs) > 1, "256-byte segments must have rotated"
    assert wal_tail_seq(d) == 30
    wal = Wal(d, DurabilityConfig(fsync="never", segment_bytes=256),
              resume=True)
    wal.truncate(20)
    remaining = list(iter_records(d))
    assert remaining[-1][0] == 30
    assert remaining[0][0] <= 21          # nothing past the snapshot lost
    assert len(os.listdir(d)) < len(segs) + 1
    wal.close()


def test_wal_truncate_respects_pinned_floor(tmp_path):
    """A pinned floor clamps truncation: records past it survive."""
    d = str(tmp_path / "wal")
    wal = Wal(d, DurabilityConfig(fsync="never", segment_bytes=128))
    for i in range(20):
        wal.append(RT_DELETE, encode_delete(np.arange(8)))
    assert wal.stats()["floor_seq"] == -1            # unpinned
    wal.pin_floor(5)
    wal.truncate(15)                                 # clamped to 5
    assert wal.stats()["floor_seq"] == 5
    wal.close()
    remaining = [seq for seq, _, _ in iter_records(d)]
    assert set(range(6, 20)).issubset(remaining)     # floor tail intact


def test_wal_torn_tail_skipped_and_truncated_on_resume(tmp_path):
    d = str(tmp_path / "wal")
    wal = Wal(d, DurabilityConfig(fsync="never"))
    for i in range(5):
        wal.append(RT_DELETE, encode_delete(np.arange(i + 1)))
    wal.close()
    path = os.path.join(d, sorted(os.listdir(d))[-1])
    with open(path, "ab") as f:
        f.write(b"\x07\x07\x07")                     # torn tail
    assert wal_tail_seq(d) == 4                      # reader stops clean
    size_torn = os.path.getsize(path)
    wal = Wal(d, DurabilityConfig(fsync="never"), resume=True)
    assert os.path.getsize(path) == size_torn - 3    # tail truncated
    assert wal.append(RT_COMPACT) == 5               # sequence continues
    wal.close()
    assert wal_tail_seq(d) == 5


def test_wal_midlog_corruption_raises(tmp_path):
    d = str(tmp_path / "wal")
    wal = Wal(d, DurabilityConfig(fsync="never", segment_bytes=128))
    for i in range(20):
        wal.append(RT_DELETE, encode_delete(np.arange(8)))
    wal.close()
    path = os.path.join(d, sorted(os.listdir(d))[0])  # NOT the last one
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF                                 # flip a payload byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(WalError):
        list(iter_records(d))


def test_wal_refuses_existing_history_without_resume(tmp_path):
    d = str(tmp_path / "wal")
    wal = Wal(d, DurabilityConfig(fsync="never"))
    wal.append(RT_COMPACT)
    wal.close()
    with pytest.raises(RuntimeError, match="load_engine"):
        Wal(d, DurabilityConfig(fsync="never"))


def test_payload_codecs_roundtrip():
    ids = np.asarray([3, -1, 7, 2**31 - 1], np.int32)
    vecs = np.arange(16, dtype=np.float32).reshape(4, 4)
    rid, rvec = decode_upsert(encode_upsert(ids, vecs))
    np.testing.assert_array_equal(rid, ids)
    np.testing.assert_array_equal(rvec, vecs)
    np.testing.assert_array_equal(decode_delete(encode_delete(ids)), ids)
    dec = {"decision": "grow", "row_extra": 256, "cell_extra": 64}
    assert decode_policy(encode_policy(dec)) == dec
    # int64 ids in range encode as JAX's int32 bytes
    assert encode_delete(ids.astype(np.int64)) == encode_delete(ids)


def test_ids_outside_int32_are_refused_not_truncated(tmp_path):
    """The log stores ids as int32: a durable engine refuses an id outside
    that range with ValueError before it logs or writes any of the batch;
    an engine that is not durable takes it (its ids are int64)."""
    eng = _engine(_cfg("flat")).durable(str(tmp_path / "live"))
    last = eng._wal.last_seq
    before = eng.store.delta_count.clone()
    big = np.asarray([700, 2**31], np.int64)
    with pytest.raises(ValueError, match="int32"):
        eng.upsert(big, _rows(1, 2))
    with pytest.raises(ValueError, match="int32"):
        eng.delete(np.asarray([-2**31 - 1]))
    with pytest.raises(ValueError, match="int32"):
        encode_upsert(big, _rows(1, 2))
    assert eng._wal.last_seq == last
    assert torch.equal(eng.store.delta_count, before)
    free = _engine(_cfg("flat"))
    free.upsert(big, _rows(1, 2))
    assert int(free.store.delta_count) == 2


# --- crash recovery at every record boundary ---------------------------------

# each op is sized under the delta compact point (48 of 64), so ops map
# 1:1 onto WAL records and an op prefix IS a record prefix
_OPS = [
    ("upsert", np.arange(600, 630, dtype=np.int32), 1),
    ("delete", np.asarray([3, 5, 600, 604], np.int32), None),
    ("upsert", np.arange(625, 640, dtype=np.int32), 2),
    ("compact", None, None),
    ("upsert", np.arange(640, 670, dtype=np.int32), 3),
    ("delete", np.asarray([10, 11, 650], np.int32), None),
    ("upsert", np.arange(7, 12, dtype=np.int32), 4),   # overwrite base rows
]


def _apply_ops(eng, ops):
    for op, ids, seed in ops:
        if op == "upsert":
            eng.upsert(ids, _rows(seed, len(ids)))
        elif op == "delete":
            eng.delete(ids)
        elif op == "compact":
            eng.compact()
        elif op == "begin":
            eng.begin_compact()
        elif op == "finish":
            eng.finish_compact()
        elif op == "save":
            eng.save(eng._durable_dir)
        elif op == "vacuum":
            eng.vacuum()
        elif op == "rebuild":
            eng.rebuild_quantizers(seed=seed)
        else:
            raise ValueError(op)


def _tail_records(live):
    """The WAL records past the newest durable snapshot's mark."""
    meta = json.load(open(os.path.join(live, "engine.json")))
    return (meta["wal_seq"],
            list(iter_records(os.path.join(live, "wal"),
                              after=meta["wal_seq"])))


def _prefix_dir(src, dst, records, p, mark_payload=b"-1"):
    """A copy of the durable directory as a crash at the boundary after
    tail record ``p`` would leave it: snapshot intact, WAL holding the
    snapshot mark (seq 0) + the first ``p`` tail records."""
    os.makedirs(dst)
    for f in os.listdir(src):
        if f != "wal":
            shutil.copy2(os.path.join(src, f), os.path.join(dst, f))
    wal = Wal(os.path.join(dst, "wal"), DurabilityConfig(fsync="never"))
    wal.append(4, mark_payload)                  # RT_SNAPSHOT mark, seq 0
    for _, rtype, payload in records[:p]:
        wal.append(rtype, payload)
    wal.close()


@pytest.mark.parametrize("index", ("flat", "ivf", "pq", "ivfpq"))
def test_recovery_at_every_record_boundary(index, tmp_path):
    """A crash after any WAL record recovers to the engine that ran
    exactly that prefix of operations: every store tensor and the ids."""
    q = _queries()
    cfg = _cfg(index)
    live = str(tmp_path / "live")
    eng = _engine(cfg).durable(live, DurabilityConfig(fsync="batch"))
    _apply_ops(eng, _OPS)
    eng._wal.sync()
    _, records = _tail_records(live)
    assert len(records) == len(_OPS)         # 1:1 op <-> record mapping
    oracle = _engine(cfg)
    for p in range(len(records) + 1):
        if p:
            _apply_ops(oracle, [_OPS[p - 1]])
        crash = str(tmp_path / f"crash{p}")
        _prefix_dir(live, crash, records, p)
        rec = load_engine(crash, device="cpu")
        assert rec._replayed == p
        _assert_same(rec, oracle, f"prefix {p}")
        np.testing.assert_array_equal(_ids(rec, q), _ids(oracle, q),
                                      err_msg=f"prefix {p}")
        rec.close()


def test_recovered_store_matches_rebuild_oracle(tmp_path):
    """After recovery + compact the store serves what a from-scratch
    rebuild over the surviving rows (same frozen quantizers) serves."""
    live = str(tmp_path / "live")
    eng = _engine(_cfg("ivfpq")).durable(live, DurabilityConfig(
        fsync="batch"))
    _apply_ops(eng, _OPS)
    rec = load_engine(live, device="cpu")
    rec.compact()
    alive = dict(enumerate(_data()))
    for op, ids, seed in _OPS:
        if op == "upsert":
            for j, rid in enumerate(ids):
                alive[int(rid)] = _rows(seed, len(ids))[j]
        elif op == "delete":
            for rid in ids:
                alive.pop(int(rid), None)
    surv_ids = np.array(sorted(alive))
    surv = np.stack([alive[i] for i in surv_ids])
    oracle = rebuild_state(rec.frozen, surv, index="ivfpq")
    q = torch.from_numpy(_queries())
    _, i_r = search_fn(oracle, q, K, nprobe=12, rerank=128)
    _, i_s = rec.search(q, K)
    np.testing.assert_array_equal(np.sort(i_s.numpy(), axis=1),
                                  np.sort(surv_ids[i_r.numpy()], axis=1))


def test_torn_tail_after_workload_recovers_to_last_record(tmp_path):
    live = str(tmp_path / "live")
    eng = _engine(_cfg("ivf")).durable(live, DurabilityConfig(fsync="batch"))
    _apply_ops(eng, _OPS)
    q = _queries()
    want = _ids(eng, q)
    wal_dir = os.path.join(live, "wal")
    seg = sorted(f for f in os.listdir(wal_dir) if f.endswith(".log"))[-1]
    with open(os.path.join(wal_dir, seg), "ab") as f:
        f.write(b"\x13\x37" * 9)                     # torn half-frame
    rec = load_engine(live, device="cpu")
    np.testing.assert_array_equal(_ids(rec, q), want)
    _assert_same(rec, eng)


# three rows: the delta (45 of its 48 used) needs no compaction first
_UPSERT = ("upsert", np.arange(700, 703, dtype=np.int32), 5)
_COMPACT = ("compact", None, None)
# the ops during which each lifecycle point fires (after _OPS[:3]), and
# the ops the engine that never crashed runs instead: the point's record
# is durable, so a compaction, vacuum or rebuild replays to completion,
# while a crashed save changes no store
_POINTS = {
    "wal_appended": ([_UPSERT], [_UPSERT]),
    "compact_begin": ([_COMPACT], [_COMPACT]),
    "compact_task": ([("begin", None, None), ("finish", None, None)],
                     [_COMPACT]),
    "compact_swap": ([_COMPACT], [_COMPACT]),
    "compact_done": ([_COMPACT], [_COMPACT]),
    "snapshot_arrays": ([("save", None, None)], []),
    "snapshot_commit": ([("save", None, None)], []),
    "vacuum": ([("vacuum", None, None)], [("vacuum", None, None)]),
    "rebuild": ([("rebuild", None, 5)], [("rebuild", None, 5)]),
}


@pytest.mark.parametrize("point", sorted(_POINTS))
def test_injected_crash_at_lifecycle_points(point, tmp_path):
    """``FailureInjector`` killing the engine at each of the JAX package's
    named lifecycle points leaves a directory that recovers to the engine
    that never crashed, tensor for tensor: everything logged before the
    kill replays (the log is ahead of the store, never behind)."""
    q = _queries()
    cfg = _cfg("ivfpq")
    live = str(tmp_path / "live")
    eng = _engine(cfg).durable(live, DurabilityConfig(fsync="batch"))
    _apply_ops(eng, _OPS[:3])
    ops, oracle_ops = _POINTS[point]
    eng.crash_hook = FailureInjector(fail_at={point}).maybe_fail
    with pytest.raises(RuntimeError, match="injected failure"):
        _apply_ops(eng, ops)
    eng.close()                          # the process is gone
    oracle = _engine(cfg)
    _apply_ops(oracle, _OPS[:3] + oracle_ops)
    rec = load_engine(live, device="cpu")
    _assert_same(rec, oracle, point)
    np.testing.assert_array_equal(_ids(rec, q), _ids(oracle, q))


def test_recovered_engine_resumes_the_log(tmp_path):
    """The recovered engine appends to the same WAL, and a second crash +
    recovery sees both histories."""
    live = str(tmp_path / "live")
    eng = _engine(_cfg("flat")).durable(live, DurabilityConfig(
        fsync="batch"))
    eng.upsert(np.arange(600, 620, dtype=np.int32), _rows(1, 20))
    rec = load_engine(live, device="cpu")
    rec.upsert(np.arange(620, 640, dtype=np.int32), _rows(2, 20))
    rec.delete(np.asarray([600, 625], np.int32))
    q = _queries()
    want = _ids(rec, q)
    rec2 = load_engine(live, device="cpu")
    assert rec2._replayed == rec._replayed + 2
    np.testing.assert_array_equal(_ids(rec2, q), want)
    _assert_same(rec2, rec)


def test_save_marks_and_truncates_the_wal(tmp_path):
    live = str(tmp_path / "live")
    eng = _engine(_cfg("flat")).durable(live, DurabilityConfig(
        fsync="batch", segment_bytes=4096))
    for s in range(4):
        eng.upsert(np.arange(600 + 20 * s, 620 + 20 * s, dtype=np.int32),
                   _rows(s, 20))
    eng.save(live)                       # durable snapshot: log is prefix
    eng.upsert(np.arange(700, 710, dtype=np.int32), _rows(9, 10))
    q = _queries()
    want = _ids(eng, q)
    rec = load_engine(live, device="cpu")
    # only the post-snapshot tail: the auto-compact barrier the last
    # upsert tripped (delta was 40/48 at the save) plus the upsert itself
    assert rec._replayed == 2
    np.testing.assert_array_equal(_ids(rec, q), want)


def test_snapshot_steps_increment_and_meta_names_checkpoint(tmp_path):
    live = str(tmp_path / "live")
    eng = _engine(_cfg("flat")).durable(live, DurabilityConfig(
        fsync="batch"))
    eng.upsert(np.arange(600, 610, dtype=np.int32), _rows(1, 10))
    eng.save(live)
    meta = json.load(open(os.path.join(live, "engine.json")))
    named = meta["ckpt"]
    assert named in os.listdir(live) and named == "ckpt_0000000001.npz"
    q = _queries()
    want = _ids(eng, q)
    stray = os.path.join(live, "ckpt_0000009999.npz")
    shutil.copy2(os.path.join(live, named), stray)
    with open(stray, "ab") as f:
        f.write(b"\x00")                 # would fail to parse if read
    rec = load_engine(live, device="cpu")
    np.testing.assert_array_equal(_ids(rec, q), want)


def test_durable_twice_raises(tmp_path):
    eng = _engine(_cfg("flat")).durable(str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="already durable"):
        eng.durable(str(tmp_path / "d2"))
    with pytest.raises(RuntimeError, match="read-only"):
        SearchEngine(_data(), ServeConfig(index="flat"),
                     device="cpu").durable(str(tmp_path / "d3"))


# --- non-blocking compaction -------------------------------------------------

def _bg_engine(index="ivf", **stream_kw):
    stream_kw.setdefault("background_compact", True)
    return _engine(_cfg(index, **stream_kw))


def test_background_compaction_atomic_swap():
    """While the fold runs on the worker, searches serve the OLD store;
    after the swap the NEW one, and writes made during the fold survive
    it."""
    eng = _bg_engine()
    gate = threading.Event()
    eng.crash_hook = lambda p: gate.wait(30) if p == "compact_task" else None
    q = _queries()
    eng.upsert(np.arange(600, 640, dtype=np.int32), _rows(1, 40))
    pre = _ids(eng, q)
    eng.upsert(np.arange(640, 660, dtype=np.int32), _rows(2, 20))
    assert eng._compact_future is not None           # the fold is pending
    for _ in range(4):
        np.testing.assert_array_equal(_ids(eng, q), pre)   # old store
    eng.delete(np.asarray([600], np.int32))
    assert 600 not in _ids(eng, q)
    gate.set()
    eng.finish_compact()
    assert eng.counters["swaps"] == 1 and eng._compact_future is None
    post = _ids(eng, q)
    assert 600 not in post
    oracle = _bg_engine(background_compact=False)
    oracle.upsert(np.arange(600, 640, dtype=np.int32), _rows(1, 40))
    oracle.upsert(np.arange(640, 660, dtype=np.int32), _rows(2, 20))
    oracle.delete(np.asarray([600], np.int32))
    oracle.compact()
    np.testing.assert_array_equal(post, _ids(oracle, q))
    eng.close()


def test_background_compaction_poll_swaps_without_explicit_finish():
    eng = _bg_engine()
    eng.upsert(np.arange(600, 640, dtype=np.int32), _rows(1, 40))
    eng.upsert(np.arange(640, 660, dtype=np.int32), _rows(2, 20))
    fut = eng._compact_future
    assert fut is not None
    fut.result()                          # wait for the fold (test only)
    eng.search(_queries(), K)             # poll point
    assert eng._compact_future is None
    assert eng.counters["swaps"] == 1
    eng.close()


def test_background_overflow_falls_back_to_blocking():
    eng = _bg_engine()
    eng.upsert(np.arange(600, 640, dtype=np.int32), _rows(1, 40))
    eng.upsert(np.arange(640, 680, dtype=np.int32), _rows(2, 40))
    assert eng._compact_future is None
    assert eng.counters["compactions"] >= 1
    assert _ids(eng, _queries()).shape == (16, K)
    eng.close()


# --- maintenance policy ------------------------------------------------------

def test_delete_triggers_vacuum_through_policy():
    eng = _engine(_cfg("ivf", policy=PolicyConfig(tombstone_density=0.2,
                                                  tombstone_min_dead=32)))
    q = _queries()
    eng.delete(np.arange(200, 500, dtype=np.int32))
    assert eng.counters["vacuums"] == 1
    assert not bool(eng.store.dead.any())          # reclaimed, not masked
    assert int(eng.store.n_rows) == N - 300
    got = _ids(eng, q)
    assert not np.any((got >= 200) & (got < 500))


def test_delete_without_policy_never_vacuums():
    eng = _engine(_cfg("ivf"))
    eng.delete(np.arange(0, 400, dtype=np.int32))
    assert eng.counters["vacuums"] == 0
    assert int(eng.store.dead.sum()) == 400


def test_policy_grow_headroom(tmp_path):
    """Capacity pressure grows the store after a compaction, and the grow
    replays from the WAL as a policy record, not a re-derivation."""
    cfg = _cfg("flat", policy=PolicyConfig(grow_headroom=2.0))
    live = str(tmp_path / "live")
    eng = _engine(cfg).durable(live, DurabilityConfig(fsync="batch"))
    cap0 = eng.store.corpus.shape[0]
    ids = np.arange(600, 600 + 3 * 48, dtype=np.int32)
    eng.upsert(ids, _rows(5, len(ids)))           # forces compactions
    eng.compact()
    assert eng.counters["policy_grows"] >= 1
    assert eng.store.corpus.shape[0] > cap0
    wal_types = [rt for _, rt, _ in iter_records(os.path.join(live, "wal"))]
    assert RT_POLICY in wal_types
    q = _queries()
    rec = load_engine(live, device="cpu")
    assert rec.store.corpus.shape[0] == eng.store.corpus.shape[0]
    np.testing.assert_array_equal(_ids(rec, q), _ids(eng, q))
    _assert_same(rec, eng)


def _drift_cfg(auto):
    return _cfg("pq", policy=PolicyConfig(drift_ratio=2.0, drift_min_rows=32,
                                          auto_rebuild=auto))


def _shifted():
    return _data(seed=4)[:48] * 6 + 30


def test_drift_advises_then_auto_rebuilds():
    adv = _engine(_drift_cfg(False))
    adv.upsert(np.arange(600, 648, dtype=np.int32), _shifted())
    adv.compact()
    assert adv._policy.decisions.get("advise_rebuild", 0) >= 1
    assert adv.counters["rebuilds"] == 0
    assert adv._policy.drift_ratio() > 2.0
    auto = _engine(_drift_cfg(True))
    auto.upsert(np.arange(600, 648, dtype=np.int32), _shifted())
    auto.compact()
    assert auto.counters["rebuilds"] == 1
    assert auto._policy.recent_rows == 0          # re-based after retrain
    assert _ids(auto, _queries()).min() >= 0


def test_rebuild_replays_deterministically(tmp_path):
    """A WAL-logged rebuild carries its seed: recovery reruns the same
    retrain (the port's seeded generator) and lands on the same store."""
    live = str(tmp_path / "live")
    eng = _engine(_drift_cfg(True)).durable(live, DurabilityConfig(
        fsync="batch"))
    eng.upsert(np.arange(600, 648, dtype=np.int32), _shifted())
    eng.compact()                                  # drift -> logged rebuild
    assert eng.counters["rebuilds"] == 1
    rec = load_engine(live, device="cpu")
    assert rec.counters["rebuilds"] == 1
    np.testing.assert_array_equal(_ids(rec, _queries()),
                                  _ids(eng, _queries()))
    _assert_same(rec, eng)


# --- the port against the JAX package ---------------------------------------

def _jax():
    jax = pytest.importorskip("jax")
    return jax


def _records():
    """Records of every type, ids at the int32 limits."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(12):
        ids = np.arange(i * 7, i * 7 + 5 + i, dtype=np.int32)
        out.append((RT_UPSERT, ids, rng.normal(size=(ids.shape[0], 6))
                    .astype(np.float32)))
        out.append((RT_DELETE, np.asarray([2**31 - 1, -2**31, i],
                                          np.int32), None))
    out.append((RT_COMPACT, None, None))
    out.append((RT_POLICY, {"decision": "grow", "row_extra": 256,
                            "cell_extra": 64}, None))
    out.append((4, b"17", None))
    return out


def _write(mod, d, records, segment_bytes):
    wal = mod.Wal(d, mod.DurabilityConfig(fsync="batch",
                                          segment_bytes=segment_bytes))
    for rtype, a, b in records:
        if rtype == mod.RT_UPSERT:
            wal.append(rtype, mod.encode_upsert(a, b))
        elif rtype == mod.RT_DELETE:
            wal.append(rtype, mod.encode_delete(a))
        elif rtype == mod.RT_POLICY:
            wal.append(rtype, mod.encode_policy(a))
        elif rtype == mod.RT_COMPACT:
            wal.append(rtype)
        else:
            wal.append(rtype, a)
    wal.close()


def test_wal_bytes_match_jax(tmp_path):
    """The same records written by both packages (with rotation) make the
    same segment files, byte for byte, and each package reads the
    other's log."""
    _jax()
    from repro.search.durability import wal as jwal
    from repro_torch.search.durability import wal as twal
    recs = _records()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    _write(jwal, jd, recs, 300)
    _write(twal, td, recs, 300)
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td)) and len(names) > 3
    for name in names:
        assert open(os.path.join(jd, name), "rb").read() == open(
            os.path.join(td, name), "rb").read(), name
    assert list(twal.iter_records(jd)) == list(jwal.iter_records(td)) == \
        list(jwal.iter_records(jd))
    assert twal.wal_tail_seq(jd) == jwal.wal_tail_seq(td) == len(recs) - 1


def _jax_store_arrays(eng):
    jax = _jax()
    flat, _ = jax.tree_util.tree_flatten_with_path(eng.store)
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v) for p, v in flat}


def _assert_store_equals_jax(tstore, jarrays, where):
    for f in tstore._fields:
        t = getattr(tstore, f)
        assert (t is None) == (f not in jarrays), (where, f)
        if t is None:
            continue
        t, j = t.numpy(), jarrays[f]
        assert t.shape == j.shape, (where, f)
        if t.dtype == np.int64:
            # the port's ids are int64: compared as the log's int32
            np.testing.assert_array_equal(t.astype(np.int32), j,
                                          err_msg=f"{where}: {f}")
        elif f in COMPUTED:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{where}: {f}")
        else:
            assert t.dtype == j.dtype, (where, f)
            np.testing.assert_array_equal(t, j, err_msg=f"{where}: {f}")


@pytest.mark.parametrize("index", ("flat", "ivfpq"))
def test_jax_written_wal_replays_into_the_port(index, tmp_path):
    """A durable JAX engine's directory (snapshot + WAL, no rebuild
    record: the port cannot reproduce jax.random, so a retrain replayed
    from a JAX log draws other quantizers) replays into the port record
    by record with every store tensor equal to the JAX engine's at every
    record boundary, ids compared as int32; ``load_engine`` recovers the
    same store in one go."""
    _jax()
    from repro.search import (DurabilityConfig as JDur, SearchEngine as JEng,
                              ServeConfig as JCfg, StreamConfig as JStream)
    kw = dict(rerank=128, index=index, fit_sample=512,
              stream=JStream(delta_capacity=64))
    if index == "ivfpq":
        kw.update(nlist=12, nprobe=12, pq_subspaces=8, pq_centroids=64)
    live = str(tmp_path / "jax")
    jeng = JEng(_data(), JCfg(**kw)).durable(live, JDur(fsync="batch"))
    joracle = JEng(_data(), JCfg(**kw))
    _apply_ops(jeng, _OPS)
    jeng._wal.sync()
    _, records = _tail_records(live)
    assert len(records) == len(_OPS)
    port = seed_follower(live, device="cpu")
    _assert_store_equals_jax(port.store, _jax_store_arrays(joracle), "seed")
    q = _queries()
    for p, rec in enumerate(records):
        _apply_ops(joracle, [_OPS[p]])
        replay_records(port, [rec])
        _assert_store_equals_jax(port.store, _jax_store_arrays(joracle),
                                 f"record {p}")
        np.testing.assert_array_equal(
            _ids(port, q), np.asarray(joracle.search(q, K)[1]),
            err_msg=f"record {p}")
    rec = load_engine(live, device="cpu")
    assert rec._replayed == len(records)
    _assert_same(rec, port)
    rec.close()


@pytest.mark.gpu
def test_cuda_recovery_equals_never_crashed(tmp_path):
    """On the card: a durable ivfpq engine on K1's route crashes inside a
    delete; load_engine recovers every store tensor of the engine that
    never crashed, bit for bit, and its ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(_cfg("ivfpq"), pq_backend="kernel",
                              lut_dtype="int8")
    live = str(tmp_path / "live")
    eng = SearchEngine(_data(), cfg, device="cuda").durable(live)
    oracle = SearchEngine(_data(), cfg, device="cuda")
    for e in (eng, oracle):
        _apply_ops(e, _OPS[:-1])
    eng.crash_hook = FailureInjector(fail_at={"wal_appended"}).maybe_fail
    with pytest.raises(RuntimeError, match="injected failure"):
        eng.upsert(_OPS[-1][1], _rows(_OPS[-1][2], len(_OPS[-1][1])))
    _apply_ops(oracle, _OPS[-1:])
    rec = load_engine(live, device="cuda")
    _assert_same(rec, oracle)
    q = _queries()
    assert torch.equal(rec.search(q, K)[1], oracle.search(q, K)[1])


def test_jax_codec_wraps_an_id_outside_int32():
    """A reference behaviour the port does not keep: the JAX package's
    codecs cast ids with ``np.ascontiguousarray(ids, np.int32)``, which
    wraps an id outside the int32 range (2**31 is logged as -2**31);
    the port's codecs raise instead, and agree byte for byte in range."""
    _jax()
    from repro.search.durability import wal as jwal
    from repro_torch.search.durability import wal as twal
    big = np.asarray([2**31, 5], np.int64)
    np.testing.assert_array_equal(
        jwal.decode_delete(jwal.encode_delete(big)), [-2**31, 5])
    with pytest.raises(ValueError, match="int32"):
        twal.encode_delete(big)
    ok = np.asarray([2**31 - 1, -2**31, 5], np.int64)
    assert jwal.encode_delete(ok) == twal.encode_delete(ok)
