"""Port parity for engine snapshots (repro_torch.search.snapshot): twins of
tests/test_snapshot.py, and the snapshot format held against the JAX
package's in both directions.

* save / load parity for every index kind and LUT dtype, the qpad, pca
  and mlp reducers, streaming snapshots taken mid-delta, the flat alias,
  runtime overrides, the guard rails (``stream=`` refused at load), and
  ``load_engine(dir, mesh=...)`` through two gloo ranks;
* the files: ``engine.json`` with the JAX package's schema and fields,
  ``ckpt_*.npz`` keyed and typed as the JAX package keys and types them;
* a snapshot the JAX package wrote (read-only, mid-delta streaming, an
  incremental chain) loads in the port with JAX's ids, and one the port
  wrote, from arrays JAX built (``bridge``), loads in JAX ``load_engine``
  with JAX's ids.

The port runs on the CPU (``device="cpu"``), its kernels' plain versions.
JAX is imported inside the tests (this file holds a ``gpu`` test, run on
the card where JAX is absent).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.bridge import state_from_arrays  # noqa: E402
from repro_torch.core.mpad import MPADConfig  # noqa: E402
from repro_torch.search import (SearchEngine, StreamConfig,  # noqa: E402
                                build_engine, load_engine)
from repro_torch.search.snapshot import snapshot_leaves  # noqa: E402

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


_SPECS = [
    "flat",
    "qpad8>rr64",
    "ivf12x5",
    "pq8x64",
    "pq8x64:i8",
    "qpad8>ivf12x5",
    "ivf12x5>pq8x64",
    "ivf12x5>pq8x64:i8",
    "qpad8>ivf12x5>pq8x64:i8",
    "opq8x64:i8>rr64",
    "pca8>ivf12x5>pq8x64:bf16@kernel>rr64",
    "mlp8>rr64",
]


def _engine(spec, **runtime):
    runtime.setdefault("fit_sample", 512)
    if spec.startswith("qpad"):
        runtime.setdefault("mpad", MPADConfig(m=8, iters=16))
    return build_engine(_data(), spec, device="cpu", **runtime)


def _ids(eng, q):
    return eng.search(q, K)[1].numpy()


@pytest.mark.parametrize("spec", _SPECS)
def test_save_load_search_parity(spec, tmp_path):
    """load_engine(save(e)).search == e.search: ids and distances."""
    eng = _engine(spec)
    q = _queries()
    d1, i1 = eng.search(q, K)
    eng.save(str(tmp_path))
    eng2 = load_engine(str(tmp_path), device="cpu")
    assert eng2.spec == eng.spec
    assert eng2.config == dataclasses.replace(eng.config, mpad=None)
    d2, i2 = eng2.search(q, K)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)


def test_restored_engine_holds_the_same_tensors(tmp_path):
    """The restored engine's tensors have the saved one's shapes, dtypes
    and values, leaf for leaf (the port's twin of the JAX test's
    no-new-program-shapes pin: a torch engine compiles nothing, so the
    shapes and dtypes are what a restore must keep)."""
    eng = _engine("qpad8>ivf12x5>pq8x64:i8")
    eng.save(str(tmp_path))
    eng2 = load_engine(str(tmp_path), device="cpu")
    a, b = snapshot_leaves(eng.state), snapshot_leaves(eng2.state)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), key
    q = _queries()
    for _ in range(3):
        np.testing.assert_array_equal(_ids(eng2, q), _ids(eng, q))


def test_runtime_overrides_on_load(tmp_path):
    eng = _engine("ivf12x5")
    eng.save(str(tmp_path))
    eng2 = load_engine(str(tmp_path), device="cpu", query_bucket=16)
    assert eng2.config.query_bucket == 16
    eng2.search(_queries(3), K)
    assert eng2.last_bucket == 4            # small-batch path intact


@pytest.mark.parametrize("spec", ["qpad8>rr128", "ivf12x5>pq8x64:i8>rr128"])
def test_streaming_snapshot_mid_delta(spec, tmp_path):
    """A snapshot taken mid-delta restores mid-delta: same results, same
    delta fill, and the write path goes on: compaction after the restore
    equals compaction without the round trip."""
    rng = np.random.RandomState(0)
    vecs = rng.randn(24, DIM).astype(np.float32)
    eng = _engine(spec, stream=StreamConfig(delta_capacity=64))
    eng.upsert(np.arange(N, N + 24), vecs)          # fresh delta rows
    eng.delete(np.arange(0, 30, 3))                 # base tombstones
    eng.upsert(np.array([5, 8]), rng.randn(2, DIM).astype(np.float32))
    q = _queries()
    d1, i1 = eng.search(q, K)
    assert int(eng.store.delta_count) > 0          # genuinely mid-delta
    eng.save(str(tmp_path))
    eng2 = load_engine(str(tmp_path), device="cpu")
    assert int(eng2.store.delta_count) == int(eng.store.delta_count)
    assert eng2._delta_used == int(eng.store.delta_count)
    for f in eng.store._fields:
        x, y = getattr(eng.store, f), getattr(eng2.store, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f
    d2, i2 = eng2.search(q, K)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    more = rng.randn(10, DIM).astype(np.float32)
    for e in (eng, eng2):
        e.upsert(np.arange(N + 100, N + 110), more)
        e.compact()
    np.testing.assert_array_equal(_ids(eng, q), _ids(eng2, q))


def test_load_rejects_stream_override(tmp_path):
    eng = _engine("flat", stream=StreamConfig(delta_capacity=64))
    eng.save(str(tmp_path))
    with pytest.raises(ValueError, match="stream"):
        load_engine(str(tmp_path), device="cpu",
                    stream=StreamConfig(delta_capacity=8))
    assert load_engine(str(tmp_path),
                       device="cpu").config.stream.delta_capacity == 64


def test_load_missing_snapshot_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="engine.json"):
        load_engine(str(tmp_path), device="cpu")


def test_snapshot_restores_reducer(tmp_path):
    eng = _engine("qpad8")
    eng.save(str(tmp_path))
    eng2 = load_engine(str(tmp_path), device="cpu")
    q = torch.from_numpy(_queries(4))
    a, b = eng.state.proj, eng2.state.proj
    assert a.kind == b.kind == "qpad"
    from repro_torch.search.reducers import reduce_vectors
    assert torch.equal(reduce_vectors(a, q), reduce_vectors(b, q))


def test_flat_alias_not_saved_twice(tmp_path):
    """flat with no Reduce stage scans the corpus itself: the snapshot
    stores the rows once and restore re-aliases the payload."""
    eng = build_engine(_data(), "flat", device="cpu")
    path = eng.save(str(tmp_path))
    with np.load(path) as data:
        assert sorted(data.files) == ["['state'].corpus"]
    assert json.load(open(tmp_path / "engine.json"))["flat_alias"]
    eng2 = load_engine(str(tmp_path), device="cpu")
    assert eng2.state.index.payload is eng2.state.corpus
    q = _queries()
    np.testing.assert_array_equal(_ids(eng, q), _ids(eng2, q))


def rank_restore(mesh, dirs, q):
    """One rank: each snapshot restored onto the mesh and searched."""
    out = {}
    for name, d in dirs.items():
        eng = load_engine(d, mesh=mesh)
        out[name] = (_ids(eng, torch.from_numpy(q)),
                     eng.state is None and eng.store is None,
                     eng.metrics().engine.sharded)
    return out


@pytest.fixture(scope="module")
def mesh_restores(tmp_path_factory):
    """A read-only and a mid-delta streaming snapshot, their unsharded
    ids, and what two gloo ranks restore from them."""
    from repro_torch.launch.mesh import run_ranks
    root = tmp_path_factory.mktemp("mesh_restore")
    q = _queries()
    ro = _engine("qpad8>ivf12x4>pq8x64:i8>rr64")
    st = _engine("ivf12x4>rr64", stream=StreamConfig(delta_capacity=64))
    rng = np.random.default_rng(3)
    st.upsert(np.arange(N, N + 20), rng.normal(size=(20, DIM)).astype(
        np.float32))
    st.delete(np.arange(0, 40, 4))
    dirs = {"read_only": str(root / "ro"), "streaming": str(root / "st")}
    ro.save(dirs["read_only"])
    st.save(dirs["streaming"])
    want = {"read_only": _ids(ro, q), "streaming": _ids(st, q)}
    st.close()
    return want, run_ranks(rank_restore, 2, (dirs, q), device="cpu")


@pytest.mark.parametrize("name", ["read_only", "streaming"])
def test_mesh_restore_through_gloo(mesh_restores, name):
    """``load_engine(dir, mesh=...)`` on two gloo ranks: every rank reads
    the shard-agnostic snapshot and keeps its slice (a read-only engine
    frees its dense copy, a streaming one keeps the replicated write
    state); the ids equal the unsharded engine's."""
    want, got = mesh_restores
    ids, dense_freed, sharded = got[name]
    np.testing.assert_array_equal(ids, want[name])
    assert sharded and dense_freed == (name == "read_only")


def test_load_runs_on_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _engine("flat").save(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_engine(str(tmp_path))


# --- the format and the JAX package -----------------------------------------

def _jax():
    return pytest.importorskip("jax")


def _jax_engine(spec, **runtime):
    from repro.core import MPADConfig as JMPAD
    from repro.search import build_engine as jbuild
    runtime.setdefault("fit_sample", 512)
    if spec.startswith("qpad"):
        runtime.setdefault("mpad", JMPAD(m=8, iters=16))
    return jbuild(_data(), spec, **runtime)


def _jax_ids(eng, q):
    return np.asarray(eng.search(q, K)[1])


def _jax_state_arrays(state):
    jax = _jax()
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# flat, ivf, pq, opq and ivfpq (int8), with no reducer, qpad and pca
_CROSS = [
    "flat",
    "ivf12x5>rr64",
    "pq8x64>rr64",
    "opq8x64>rr64",
    "ivf12x5>pq8x64:i8>rr128",
    "qpad8>ivf12x5>pq8x64:i8>rr128",
    "pca8>pq8x64>rr64",
]


@pytest.mark.parametrize("spec", _CROSS)
def test_read_only_snapshots_cross_both_ways(spec, tmp_path):
    """A JAX-written read-only snapshot loads in the port with JAX's ids;
    the port engine on the same JAX-built arrays (``bridge``) writes a
    snapshot with the same keys, dtypes and ``engine.json`` fields, which
    JAX ``load_engine`` reads back to JAX's ids."""
    _jax()
    from repro.search import load_engine as jload
    q = _queries()
    jeng = _jax_engine(spec)
    want = _jax_ids(jeng, q)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpath = jeng.save(jdir)
    port = load_engine(jdir, device="cpu")
    np.testing.assert_array_equal(_ids(port, q), want)
    teng = SearchEngine.from_state(
        state_from_arrays(_jax_state_arrays(jeng.state), spec, "cpu"),
        port.config)
    tpath = teng.save(tdir)
    jarr, tarr = _npz(jpath), _npz(tpath)
    assert sorted(jarr) == sorted(tarr)
    for key in jarr:
        assert jarr[key].dtype == tarr[key].dtype, key
        assert jarr[key].shape == tarr[key].shape, key
    jmeta = json.load(open(os.path.join(jdir, "engine.json")))
    tmeta = json.load(open(os.path.join(tdir, "engine.json")))
    assert jmeta.keys() == tmeta.keys()
    for field in ("schema", "spec", "kind", "streaming", "has_proj",
                  "reducer", "flat_alias", "store_fields", "ckpt", "stream",
                  "wal_seq", "durability", "incremental", "chain"):
        assert jmeta[field] == tmeta[field], field
    # the Pallas interpret switch has no counterpart: the port writes false
    assert tmeta["runtime"].pop("pq_interpret") is False
    jmeta["runtime"].pop("pq_interpret")
    assert jmeta["runtime"] == tmeta["runtime"]
    back = jload(tdir, pq_interpret=True)
    np.testing.assert_array_equal(_jax_ids(back, q), want)


def test_streaming_mid_delta_snapshot_crosses_both_ways(tmp_path):
    """A JAX streaming ivfpq engine snapshotted mid-delta (delta rows,
    tombstones, a base overwrite) loads in the port with every store
    tensor equal (ids as int32) and JAX's ids; the port's snapshot of the
    restored engine loads back in JAX with the same ids."""
    _jax()
    from repro.search import StreamConfig as JStream
    from repro.search import load_engine as jload
    spec = "ivf12x5>pq8x64:i8>rr128"
    rng = np.random.RandomState(0)
    jeng = _jax_engine(spec, stream=JStream(delta_capacity=64))
    jeng.upsert(np.arange(N, N + 24), rng.randn(24, DIM).astype(np.float32))
    jeng.delete(np.arange(0, 30, 3))
    jeng.upsert(np.array([5, 8]), rng.randn(2, DIM).astype(np.float32))
    q = _queries()
    want = _jax_ids(jeng, q)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpath = jeng.save(jdir)
    port = load_engine(jdir, device="cpu")
    assert int(port.store.delta_count) == int(jeng.store.delta_count) > 0
    for f in port.store._fields:
        j, t = getattr(jeng.store, f), getattr(port.store, f)
        assert (j is None) == (t is None), f
        if t is not None:
            t = t.numpy()
            t = t.astype(np.int32) if t.dtype == np.int64 else t
            assert t.dtype == np.asarray(j).dtype, f
            np.testing.assert_array_equal(t, np.asarray(j), err_msg=f)
    np.testing.assert_array_equal(_ids(port, q), want)
    tpath = port.save(tdir)
    jarr, tarr = _npz(jpath), _npz(tpath)
    assert sorted(jarr) == sorted(tarr)
    for key in jarr:
        assert jarr[key].dtype == tarr[key].dtype, key
        np.testing.assert_array_equal(jarr[key], tarr[key], err_msg=key)
    back = jload(tdir, pq_interpret=True)
    np.testing.assert_array_equal(_jax_ids(back, q), want)


def test_incremental_chain_crosses_both_ways(tmp_path):
    """A JAX durable engine's incremental chain (a full base and two
    delta-only links) loads in the port with JAX's ids and no replay; the
    port, resuming the same directory, extends the chain with a link of
    its own, which JAX ``load_engine`` reads back to the port's ids."""
    _jax()
    from repro.search import DurabilityConfig as JDur
    from repro.search import SearchEngine as JEng
    from repro.search import ServeConfig as JCfg
    from repro.search import StreamConfig as JStream
    from repro.search import load_engine as jload
    kw = dict(index="flat", rerank=128, stream=JStream(delta_capacity=64))
    jdir = str(tmp_path / "live")
    jeng = JEng(_data(), JCfg(**kw)).durable(jdir, JDur(fsync="batch"))
    rng = np.random.RandomState(1)
    jeng.upsert(np.arange(600, 620, dtype=np.int32),
                rng.randn(20, DIM).astype(np.float32))
    jeng.save(jdir, incremental=True)
    jeng.delete(np.asarray([3, 610], np.int32))
    jeng.save(jdir, incremental=True)
    assert len(json.load(open(os.path.join(jdir, "engine.json")))
               ["chain"]) == 3
    q = _queries()
    want = _jax_ids(jeng, q)
    jeng._wal.close()                          # JAX's process is gone
    port = load_engine(jdir, device="cpu")     # resumes the same log
    assert port._replayed == 0
    np.testing.assert_array_equal(_ids(port, q), want)
    port.upsert(np.arange(700, 705), rng.randn(5, DIM).astype(np.float32))
    port.delete(np.asarray([7, 615]))
    port.save(jdir, incremental=True)
    meta = json.load(open(os.path.join(jdir, "engine.json")))
    assert meta["incremental"] and len(meta["chain"]) == 4
    port.close()
    back = jload(jdir)
    assert back._replayed == 0
    np.testing.assert_array_equal(_jax_ids(back, q), _ids(port, q))


@pytest.mark.gpu
def test_cuda_round_trip(tmp_path):
    """On the card: an ivfpq engine on K1 (int8) saved and restored
    returns the same ids and distances at every batch, read-only and
    streaming mid-delta."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = "qpad8>ivf12x5>pq8x64:i8@kernel>rr64"
    q = torch.from_numpy(_queries()).cuda()
    for stream in (None, StreamConfig(delta_capacity=64)):
        eng = build_engine(_data(), spec, device="cuda", fit_sample=512,
                           mpad=MPADConfig(m=8, iters=16), stream=stream)
        if stream is not None:
            eng.upsert(np.arange(N, N + 20), _data(seed=3, n=20))
            eng.delete(np.arange(0, 30, 3))
        d = str(tmp_path / ("stream" if stream else "ro"))
        eng.save(d)
        eng2 = load_engine(d)
        for b in (1, 8, 16):
            d1, i1 = eng.search(q[:b], K)
            d2, i2 = eng2.search(q[:b], K)
            assert torch.equal(i1, i2) and torch.equal(d1, d2)
