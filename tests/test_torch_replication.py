"""Port parity for replication and the operations layer
(repro_torch.search.durability.replication, incremental snapshots, group
commit): twins of tests/test_replication.py, held to the same contracts.

* **follower parity**: a follower seeded from a primary snapshot and
  caught up through the shipped WAL equals the primary at EVERY record
  boundary, every store tensor and the ids, for flat / ivf / pq / ivfpq,
  across compaction, vacuum and a quantizer rebuild, which the follower
  re-folds from the logged RT_COMPACT / RT_POLICY records.
* **divergence**: a seq gap, a CRC failure mid-shipment or a rewound
  source raises ``DivergenceError``; a re-seeded follower rejoins.
  Followers refuse local writes; a primary cannot catch_up.
* **incremental snapshots**: delta-only chain links restore exactly;
  base-rewriting maintenance forces a full save; the chained base pins
  the WAL truncation floor.
* **group commit**: concurrent ``fsync="always"`` appends share fsyncs,
  each record exactly once and in order; append returns after a covering
  sync.

The port runs on the CPU (``device="cpu"``), its kernels' plain versions.
"""
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
                                StreamConfig, load_engine)
from repro_torch.search.durability import (  # noqa: E402
    DivergenceError, DurabilityConfig, LocalDirSource, PolicyConfig,
    ReplicationError, Wal, catch_up, seed_follower)
from repro_torch.search.durability.wal import (  # noqa: E402
    RT_UPSERT, decode_upsert, encode_upsert, iter_records)

N, DIM, K = 600, 32, 10


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


def _rows(seed, n):
    return _data(seed=seed, n=n)


# each op sized under the delta compact point (48 of 64): ops map 1:1
# onto WAL records, so an op boundary IS a record boundary
_OPS = [
    ("upsert", np.arange(600, 630, dtype=np.int32), 1),
    ("delete", np.asarray([3, 5, 600, 604], np.int32), None),
    ("upsert", np.arange(625, 640, dtype=np.int32), 2),
    ("compact", None, None),
    ("upsert", np.arange(640, 670, dtype=np.int32), 3),
    ("delete", np.asarray([10, 11, 650], np.int32), None),
    ("upsert", np.arange(7, 12, dtype=np.int32), 4),
]


def _apply_ops(eng, ops):
    for op, ids, seed in ops:
        if op == "upsert":
            eng.upsert(ids, _rows(seed, len(ids)))
        elif op == "delete":
            eng.delete(ids)
        elif op == "vacuum":
            eng.vacuum()
        elif op == "rebuild":
            eng.rebuild_quantizers(seed=seed)
        else:
            eng.compact()


def _ids(eng, q):
    return eng.search(q, K)[1].numpy()


def _assert_same_store(a, b, where=""):
    for f in a.store._fields:
        x, y = getattr(a.store, f), getattr(b.store, f)
        assert (x is None) == (y is None), (where, f)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), (where, f)


def _primary(tmp_path, index="flat", dcfg=None, **stream_kw):
    live = str(tmp_path / "live")
    eng = SearchEngine(_data(), _cfg(index, **stream_kw), device="cpu")
    eng.durable(live, dcfg or DurabilityConfig(fsync="batch"))
    return eng, live


def _seed(directory):
    return seed_follower(directory, device="cpu")


# --- follower catch-up parity ------------------------------------------------

@pytest.mark.parametrize("index", ("flat", "ivf", "pq", "ivfpq"))
def test_follower_parity_at_every_record_boundary(index, tmp_path):
    """After every primary op (one WAL record), one catch_up pass lands
    the follower on the primary's store and ids, across the compaction
    barrier at op 4, which the follower re-folds from the RT_COMPACT
    record."""
    q = _queries()
    eng, live = _primary(tmp_path, index)
    fol = _seed(live)
    src = LocalDirSource(live)
    _assert_same_store(fol, eng, "boundary 0")
    for i, op in enumerate(_OPS):
        _apply_ops(eng, [op])
        eng._wal.sync()
        st = catch_up(fol, src)
        assert st.records >= 1 and st.lag_seq == 0
        _assert_same_store(fol, eng, f"boundary {i + 1}")
        np.testing.assert_array_equal(_ids(fol, q), _ids(eng, q),
                                      err_msg=f"boundary {i + 1}")
    again = catch_up(fol, src)
    assert again.records == 0 and again.lag_seq == 0
    assert fol._applied_seq == eng._wal.last_seq
    assert fol._repl_catch_ups == len(_OPS) + 1
    assert fol._repl_records == eng._wal.last_seq - 0
    assert fol._repl_caught_up_ts is not None


def test_follower_refolds_vacuum_from_policy_record(tmp_path):
    """A primary-side policy vacuum ships as RT_DELETE + RT_POLICY: the
    follower runs the reclaim itself and lands on the same store."""
    q = _queries()
    eng, live = _primary(tmp_path, "ivf",
                         policy=PolicyConfig(tombstone_density=0.2,
                                             tombstone_min_dead=32))
    fol = _seed(live)
    eng.delete(np.arange(200, 500, dtype=np.int32))   # triggers vacuum
    assert eng.counters["vacuums"] == 1
    eng._wal.sync()
    st = catch_up(fol, LocalDirSource(live))
    assert st.deletes == 1 and st.policies == 1
    assert fol.counters["vacuums"] == 1
    _assert_same_store(fol, eng)
    got = _ids(fol, q)
    np.testing.assert_array_equal(got, _ids(eng, q))
    assert not np.any((got >= 200) & (got < 500))


def test_follower_refolds_a_quantizer_rebuild(tmp_path):
    """Port against port: a primary's quantizer rebuild ships as one
    RT_POLICY record with its seed; the follower retrains with the port's
    seeded generator and lands on the same quantizers, store and ids."""
    q = _queries()
    eng, live = _primary(tmp_path, "ivfpq")
    fol = _seed(live)
    _apply_ops(eng, _OPS[:3] + [("rebuild", None, 7)] + _OPS[4:])
    eng._wal.sync()
    st = catch_up(fol, LocalDirSource(live))
    assert st.policies == 1 and fol.counters["rebuilds"] == 1
    assert fol.config.seed == eng.config.seed == 7
    _assert_same_store(fol, eng)
    assert torch.equal(fol.frozen.codebooks, eng.frozen.codebooks)
    np.testing.assert_array_equal(_ids(fol, q), _ids(eng, q))


def test_crash_mid_catch_up_reseeds_cleanly(tmp_path):
    q = _queries()
    eng, live = _primary(tmp_path, "ivf")
    _apply_ops(eng, _OPS)
    eng._wal.sync()
    fol = _seed(live)
    fol.crash_hook = FailureInjector(fail_at={"compact_begin"}).maybe_fail
    pos = fol._applied_seq
    with pytest.raises(RuntimeError, match="injected failure"):
        catch_up(fol, LocalDirSource(live))
    assert fol._applied_seq == pos       # position advances only on success
    fresh = _seed(live)
    st = catch_up(fresh, LocalDirSource(live))
    assert st.records == len(_OPS)
    np.testing.assert_array_equal(_ids(fresh, q), _ids(eng, q))
    _assert_same_store(fresh, eng)


# --- divergence --------------------------------------------------------------

def test_divergence_on_truncated_history(tmp_path):
    q = _queries()
    eng, live = _primary(
        tmp_path, "flat",
        dcfg=DurabilityConfig(fsync="batch", segment_bytes=256))
    stale_seed = str(tmp_path / "stale")
    shutil.copytree(live, stale_seed)
    _apply_ops(eng, _OPS[:3])
    eng.save(live)                        # floor moves; prefix truncated
    _apply_ops(eng, _OPS[3:])
    eng._wal.sync()
    stale = _seed(stale_seed)
    with pytest.raises(DivergenceError, match="re-seed"):
        catch_up(stale, LocalDirSource(live))
    reseed = str(tmp_path / "reseed")
    shutil.copytree(live, reseed, ignore=shutil.ignore_patterns("wal"))
    fol = _seed(reseed)
    catch_up(fol, LocalDirSource(live))
    np.testing.assert_array_equal(_ids(fol, q), _ids(eng, q))


def test_divergence_on_corrupt_shipment(tmp_path):
    eng, live = _primary(
        tmp_path, "flat",
        dcfg=DurabilityConfig(fsync="batch", segment_bytes=256))
    _apply_ops(eng, _OPS)
    eng._wal.sync()
    ship = str(tmp_path / "ship")
    shutil.copytree(os.path.join(live, "wal"), ship)
    segs = sorted(f for f in os.listdir(ship) if f.endswith(".log"))
    assert len(segs) > 2, "256-byte segments must have rotated"
    path = os.path.join(ship, segs[1])    # mid-stream, NOT the last segment
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    open(path, "wb").write(bytes(data))
    fol = _seed(live)
    with pytest.raises(DivergenceError, match="[Rr]e-seed"):
        catch_up(fol, LocalDirSource(ship))


def test_divergence_on_rewound_source(tmp_path):
    eng, live = _primary(tmp_path, "flat")
    stale_src = str(tmp_path / "stale")
    shutil.copytree(live, stale_src)
    _apply_ops(eng, _OPS[:2])
    eng._wal.sync()
    fol = _seed(live)
    catch_up(fol, LocalDirSource(live))   # follower is ahead of stale_src
    with pytest.raises(DivergenceError, match="rewound"):
        catch_up(fol, LocalDirSource(stale_src))


def test_follower_rejects_local_writes_and_role_misuse(tmp_path):
    eng, live = _primary(tmp_path, "flat")
    fol = _seed(live)
    with pytest.raises(ReplicationError, match="follower"):
        fol.upsert(np.asarray([900], np.int32), _rows(1, 1))
    with pytest.raises(ReplicationError, match="follower"):
        fol.delete(np.asarray([3], np.int32))
    with pytest.raises(ReplicationError, match="follower"):
        fol.compact()
    with pytest.raises(ReplicationError, match="follower"):
        fol.durable(str(tmp_path / "fwal"))
    with pytest.raises(ReplicationError, match="primary"):
        catch_up(eng, LocalDirSource(live))
    ro = SearchEngine(_data(), ServeConfig(index="flat"), device="cpu")
    with pytest.raises(ReplicationError, match="streaming"):
        catch_up(ro, LocalDirSource(live))
    fresh = SearchEngine(_data(), _cfg("flat"), device="cpu")
    with pytest.raises(ValueError, match="follower"):
        fresh.durable(str(tmp_path / "d2"),
                      DurabilityConfig(role="follower"))
    with pytest.raises(ValueError, match="role"):
        load_engine(live, role="observer", device="cpu")


def test_durability_config_validation():
    with pytest.raises(ValueError, match="role"):
        DurabilityConfig(role="observer")
    with pytest.raises(ValueError, match="fsync"):
        DurabilityConfig(fsync="sometimes")
    with pytest.raises(ValueError, match="group_commit_ms"):
        DurabilityConfig(group_commit_ms=-1.0)
    with pytest.raises(ValueError, match="always"):
        DurabilityConfig(fsync="batch", group_commit_ms=2.0)
    with pytest.raises(ValueError, match="always"):
        DurabilityConfig(fsync="never", group_commit_ms=2.0)
    DurabilityConfig(fsync="always", group_commit_ms=2.0)   # coherent


# --- incremental snapshots ---------------------------------------------------

def test_incremental_snapshot_chain_roundtrip(tmp_path):
    q = _queries()
    eng, live = _primary(tmp_path, "flat")
    base_meta = json.load(open(os.path.join(live, "engine.json")))
    full_bytes = os.path.getsize(os.path.join(live, base_meta["ckpt"]))
    eng.upsert(np.arange(600, 620, dtype=np.int32), _rows(1, 20))
    p1 = eng.save(live, incremental=True)
    assert os.path.getsize(p1) < 0.5 * full_bytes
    meta = json.load(open(os.path.join(live, "engine.json")))
    assert meta["incremental"] and meta["base_ckpt"] == base_meta["ckpt"]
    assert len(meta["chain"]) == 2
    np.testing.assert_array_equal(_ids(load_engine(live, device="cpu"), q),
                                  _ids(eng, q))
    eng.delete(np.asarray([3, 610], np.int32))
    eng.upsert(np.arange(615, 625, dtype=np.int32), _rows(2, 10))
    eng.save(live, incremental=True)
    meta = json.load(open(os.path.join(live, "engine.json")))
    assert len(meta["chain"]) == 3
    assert eng._snap_counters["chain_depth"] == 2
    rec = load_engine(live, device="cpu")
    np.testing.assert_array_equal(_ids(rec, q), _ids(eng, q))
    _assert_same_store(rec, eng)
    assert rec._replayed == 0            # the chain covered the log


def test_incremental_requires_clean_durable_base(tmp_path):
    eng, live = _primary(tmp_path, "flat")
    with pytest.raises(ValueError, match="durable base"):
        eng.save(str(tmp_path / "elsewhere"), incremental=True)
    eng.upsert(np.arange(600, 660, dtype=np.int32), _rows(1, 60))
    assert eng.counters["compactions"] >= 1
    with pytest.raises(ValueError, match="full snapshot"):
        eng.save(live, incremental=True)
    eng.save(live)                       # new base, new chain
    eng.upsert(np.arange(700, 710, dtype=np.int32), _rows(2, 10))
    eng.save(live, incremental=True)     # chains again
    q = _queries()
    np.testing.assert_array_equal(_ids(load_engine(live, device="cpu"), q),
                                  _ids(eng, q))
    free = SearchEngine(_data(), _cfg("flat"), device="cpu")
    with pytest.raises(ValueError, match="durable base"):
        free.save(str(tmp_path / "free"), incremental=True)
    ro = SearchEngine(_data(), ServeConfig(index="flat"), device="cpu")
    with pytest.raises(ValueError, match="read-only"):
        ro.save(str(tmp_path / "ro"), incremental=True)


def test_crash_mid_incremental_save_falls_back(tmp_path):
    q = _queries()
    eng, live = _primary(tmp_path, "flat")
    eng.upsert(np.arange(600, 620, dtype=np.int32), _rows(1, 20))
    want = _ids(eng, q)
    eng.crash_hook = FailureInjector(fail_at={"snapshot_arrays"}).maybe_fail
    with pytest.raises(RuntimeError, match="injected failure"):
        eng.save(live, incremental=True)
    rec = load_engine(live, device="cpu")  # old manifest + replayed tail
    assert rec._replayed == 1
    np.testing.assert_array_equal(_ids(rec, q), want)
    rec.close()
    eng.crash_hook = None
    eng.save(live, incremental=True)     # retry commits
    rec = load_engine(live, device="cpu")
    assert rec._replayed == 0
    np.testing.assert_array_equal(_ids(rec, q), want)


def test_incremental_pins_wal_floor_for_base_followers(tmp_path):
    q = _queries()
    eng, live = _primary(
        tmp_path, "flat",
        dcfg=DurabilityConfig(fsync="batch", segment_bytes=256))
    base_seed = str(tmp_path / "seed")
    shutil.copytree(live, base_seed)
    base_seq = eng._wal.last_seq
    for s in range(3):
        eng.upsert(np.arange(600 + 10 * s, 610 + 10 * s, dtype=np.int32),
                   _rows(s, 10))
    eng.save(live, incremental=True)
    assert eng._wal.stats()["floor_seq"] == base_seq
    seqs = [s for s, _, _ in
            iter_records(os.path.join(live, "wal"), after=base_seq)]
    assert seqs[0] == base_seq + 1
    eng.upsert(np.arange(630, 640, dtype=np.int32), _rows(7, 10))
    eng._wal.sync()
    fol = _seed(base_seed)
    catch_up(fol, LocalDirSource(live))
    np.testing.assert_array_equal(_ids(fol, q), _ids(eng, q))
    eng.save(live)
    assert eng._wal.stats()["floor_seq"] > base_seq
    eng.upsert(np.arange(650, 660, dtype=np.int32), _rows(8, 10))
    eng._wal.sync()
    stale = _seed(base_seed)
    with pytest.raises(DivergenceError, match="re-seed"):
        catch_up(stale, LocalDirSource(live))


# --- group commit ------------------------------------------------------------

def test_group_commit_concurrent_appends_exact_once(tmp_path):
    """8 threads of fsync=always appends under a 2 ms gather window land
    exactly once, in seq order, with fewer fsyncs than records."""
    d = str(tmp_path / "wal")
    wal = Wal(d, DurabilityConfig(fsync="always", group_commit_ms=2.0))
    n_threads, per = 8, 24

    def writer(t):
        for i in range(per):
            rid = np.asarray([t * per + i], np.int32)
            wal.append(RT_UPSERT,
                       encode_upsert(rid, np.full((1, 4), float(t),
                                                  np.float32)))

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    st = wal.stats()
    total = n_threads * per
    assert st["records"] == total
    assert st["durable_seq"] == st["last_seq"] == total - 1
    assert st["fsyncs"] < total          # coalesced
    assert st["group_commits"] >= 1
    wal.close()
    got = list(iter_records(d))
    assert [s for s, _, _ in got] == list(range(total))
    ids = sorted(int(decode_upsert(p)[0][0]) for _, _, p in got)
    assert ids == list(range(total))


def test_group_commit_append_returns_durable(tmp_path):
    d = str(tmp_path / "wal")
    wal = Wal(d, DurabilityConfig(fsync="always", group_commit_ms=2.0))
    seq = wal.append(RT_UPSERT, encode_upsert(
        np.asarray([1], np.int32), np.ones((1, 4), np.float32)))
    assert wal.stats()["durable_seq"] >= seq
    wal.close()
    eng, live = _primary(
        tmp_path, "flat",
        dcfg=DurabilityConfig(fsync="always", group_commit_ms=2.0))
    # 100 rows = 3 chunks: each appends wait=False, the batch waits once
    eng.upsert(np.arange(600, 700, dtype=np.int32), _rows(1, 100))
    st = eng._wal.stats()
    assert st["durable_seq"] == st["last_seq"]
    assert st["group_commit_ms"] == 2.0
    eng.close()


def test_group_commit_crash_after_append_recovers_the_write(tmp_path):
    q = _queries()
    eng, live = _primary(
        tmp_path, "flat",
        dcfg=DurabilityConfig(fsync="always", group_commit_ms=2.0))
    eng.crash_hook = FailureInjector(fail_at={"wal_appended"}).maybe_fail
    with pytest.raises(RuntimeError, match="injected failure"):
        eng.upsert(np.arange(600, 620, dtype=np.int32), _rows(1, 20))
    eng._wal.close()                     # the simulated process death
    rec = load_engine(live, device="cpu")
    assert rec._replayed == 1
    oracle = SearchEngine(_data(), _cfg("flat"), device="cpu")
    oracle.upsert(np.arange(600, 620, dtype=np.int32), _rows(1, 20))
    np.testing.assert_array_equal(_ids(rec, q), _ids(oracle, q))
    _assert_same_store(rec, oracle)
    rec.close()
