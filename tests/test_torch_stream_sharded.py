"""Sharded streaming serving of the port over gloo ranks on the CPU (twin
of tests/test_stream_sharded.py): the base split over the ranks, the
delta, tombstones and id maps replicated. The port's sharded streaming
engine, started from JAX's store after a first batch of writes
(``bridge.stream_from_arrays``), must return the ids of JAX's
single-device streaming engine after those writes, after more writes
made while sharded (which must not re-shard), and after a compaction
(which re-lays the base out): flat, ivf, pq, opq and ivfpq at 1, 2 and 8
ranks; int8 tables, the kernel backend (its plain version here, which
scores as the plain backend does, so JAX's plain search is its reference)
and a projection at 2; donation refused. Background compaction at 2
ranks, one rank's fold held back: the swap waits for every rank's fold.

JAX runs in this process only; the ranks are spawned once a world size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

N, DIM, K = 601, 32, 10
WORLDS = (1, 2, 8)
STAGES = ("written", "written_sharded", "compacted")
KINDS = ("flat", "ivf", "pq", "opq", "ivfpq")
# world-2 extras: (name, kind, lut, backend, target_dim); the table dtype
# and the backend are search knobs, so the ivfpq ones start from the ivfpq
# kind's store
EXTRAS = (("ivfpq-int8-jnp", "ivfpq", "int8", "jnp", None),
          ("ivfpq-f32-kernel", "ivfpq", "f32", "kernel", None),
          ("ivfpq-int8-kernel", "ivfpq", "int8", "kernel", None),
          ("ivfpq-qpad8", "ivfpq", "f32", "jnp", 8))
LUTS = ("f32", "int8")


def _data(seed=0, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2
    lab = rng.integers(0, 12, n)
    return (centers[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _queries(nq=24):
    rng = np.random.default_rng(9)
    return (_data()[:nq] + 0.02 * rng.normal(size=(nq, DIM))).astype(
        np.float32)


def _config_kw(kind, lut="f32", backend="jnp", target_dim=None):
    kw = dict(target_dim=target_dim, rerank=64, index=kind, fit_sample=512)
    if kind in ("ivf", "ivfpq"):
        kw.update(nlist=12, nprobe=5)
    if kind in ("pq", "opq", "ivfpq"):
        kw.update(pq_subspaces=8, pq_centroids=64, lut_dtype=lut,
                  pq_backend=backend)
    return kw


def _writes():
    """The first batch (before sharding) and the second (while sharded)."""
    rng = np.random.default_rng(1)
    first = [("upsert", np.arange(N, N + 20),
              rng.normal(size=(20, DIM)).astype(np.float32)),
             ("delete", np.arange(0, 30, 3), None),
             ("upsert", np.array([5, 8]),
              rng.normal(size=(2, DIM)).astype(np.float32))]
    second = [("delete", np.arange(10, 20), None),
              ("upsert", np.arange(N + 100, N + 130),
               rng.normal(size=(30, DIM)).astype(np.float32))]
    return first, second


def _apply(eng, writes):
    for op, ids, vecs in writes:
        if op == "upsert":
            eng.upsert(ids, vecs)
        else:
            eng.delete(ids)


def rank_streams(mesh, scenarios, q):
    """One rank: each scenario's port engine from JAX's store, sharded,
    searched at each stage; rank 0's ids are the result."""
    from repro_torch.bridge import stream_from_arrays
    from repro_torch.search import SearchEngine, ServeConfig, StreamConfig
    from repro_torch.search.spec import format_spec
    qt = torch.from_numpy(q)
    _, second = _writes()
    out = {}
    for name, (kw, arrays) in scenarios.items():
        cfg = ServeConfig(**kw, stream=StreamConfig(delta_capacity=64))
        store, frozen = stream_from_arrays(arrays, format_spec(cfg.to_spec()),
                                           device="cpu")
        eng = SearchEngine.from_store(store, frozen, cfg)
        try:
            eng.shard(mesh, donate=True)
            refused = False
        except ValueError:
            refused = True
        eng.shard(mesh)
        ids = {"written": eng.search(qt, K)[1].numpy()}
        base = eng._stream_sharded_base
        _apply(eng, second[:1])
        kept = eng._stream_sharded_base is base    # a delete: no re-shard
        _apply(eng, second[1:])                    # fills the delta past
        #                                            its compact point
        ids["written_sharded"] = eng.search(qt, K)[1].numpy()
        eng.compact()
        relaid = eng._stream_sharded_base is not base
        ids["compacted"] = eng.search(qt, K)[1].numpy()
        out[name] = dict(ids=ids, refused=refused, kept=kept, relaid=relaid,
                         sharded=eng.metrics().engine.sharded)
    return out


def rank_background(mesh, scenarios, q):
    """One rank: each scenario's engine from JAX's store with background
    compaction, sharded, beside an unsharded engine from the same store
    (the reference). Two upserts start a fold; rank 1's fold (and the
    reference's) wait at ``compact_task`` until after a search, which
    rank 0 makes with its own fold done. No rank may swap then (ids equal
    the reference's, which has not swapped either); once every fold is
    done, one search swaps on every rank."""
    import threading

    from repro_torch.bridge import stream_from_arrays
    from repro_torch.parallel.context import all_gather, all_reduce_sum
    from repro_torch.search import SearchEngine, ServeConfig, StreamConfig
    from repro_torch.search.spec import format_spec
    new = np.random.default_rng(2).normal(size=(40, DIM)).astype(np.float32)
    qt = torch.from_numpy(np.concatenate([new[::4], q]))

    def swaps(eng):
        return all_gather(mesh, torch.tensor([eng.counters["swaps"]]),
                          dim=0).tolist()

    out = {}
    for name, (kw, arrays) in scenarios.items():
        cfg = ServeConfig(**kw, stream=StreamConfig(
            delta_capacity=64, background_compact=True))
        engines = [SearchEngine.from_store(*stream_from_arrays(
            arrays, format_spec(cfg.to_spec()), device="cpu"), cfg)
            for _ in range(2)]
        eng, ref = engines
        eng.shard(mesh)
        gate = threading.Event()

        def hold(point):
            if point == "compact_task":
                gate.wait(60)

        ref.crash_hook = hold
        if mesh.rank == 1:
            eng.crash_hook = hold
        for e in engines:        # the second upsert crosses the compact point
            e.upsert(np.arange(N + 200, N + 220), new[:20])
            e.upsert(np.arange(N + 220, N + 240), new[20:])
        pending = (eng._compact_future is not None
                   and ref._compact_future is not None)
        if pending and mesh.rank == 0:
            eng._compact_future.result()
        ids = {"held": eng.search(qt, K)[1].numpy()}
        want = {"held": ref.search(qt, K)[1].numpy()}
        swapped = {"held": swaps(eng)}
        gate.set()
        if eng._compact_future is not None:
            eng._compact_future.result()
        all_reduce_sum(mesh, torch.zeros(1))       # every rank's fold done
        ids["swapped"] = eng.search(qt, K)[1].numpy()
        swapped["swapped"] = swaps(eng)
        ref.finish_compact()
        want["swapped"] = ref.search(qt, K)[1].numpy()
        for e in engines:
            e.close()
        out[name] = dict(ids=ids, want=want, swaps=swapped, pending=pending)
    return out


def _store_arrays(eng):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(
        {"store": eng.store, "frozen": eng.frozen})
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _jax_stages(jeng, q):
    """JAX's ids at each stage after the first writes, with every table
    dtype of ``LUTS`` (a search knob: the store is the same)."""
    import dataclasses
    base = jeng.config
    luts = LUTS if base.index in ("pq", "opq", "ivfpq") else ("f32",)

    def search():
        out = {}
        for lut in luts:
            jeng.config = dataclasses.replace(base, lut_dtype=lut)
            out[lut] = np.asarray(jeng.search(q, K)[1])
        jeng.config = base
        return out

    _, second = _writes()
    ids = {"written": search()}
    _apply(jeng, second)
    ids["written_sharded"] = search()
    jeng.compact()
    ids["compacted"] = search()
    return ids


@pytest.fixture(scope="module")
def runs():
    """JAX's single-device streaming ids at each stage, and the ranks'
    (the main kinds at each world size, the extras at 2)."""
    from repro.core import MPADConfig
    from repro.search import SearchEngine, ServeConfig, StreamConfig
    from repro_torch.launch.mesh import run_ranks
    q = _queries()
    first, _ = _writes()
    want, stores = {}, {}
    for kind, target_dim in [(k, None) for k in KINDS] + [("ivfpq", 8)]:
        kw = _config_kw(kind, target_dim=target_dim)
        jeng = SearchEngine(_data(), ServeConfig(
            **kw, mpad=MPADConfig(m=8, iters=16) if target_dim else None,
            stream=StreamConfig(delta_capacity=64)))
        _apply(jeng, first)
        stores[(kind, target_dim)] = _store_arrays(jeng)
        want[(kind, target_dim)] = _jax_stages(jeng, q)
    scenarios = {kind: (_config_kw(kind), stores[(kind, None)])
                 for kind in KINDS}
    for name, kind, lut, backend, target_dim in EXTRAS:
        scenarios[name] = (_config_kw(kind, lut, backend, target_dim),
                           stores[(kind, target_dim)])
        want[name] = {stage: ids[lut] for stage, ids in
                      want[(kind, target_dim)].items()}
    for kind in KINDS:
        want[kind] = {stage: ids["f32"] for stage, ids in
                      want[(kind, None)].items()}
    main = {k: v for k, v in scenarios.items() if k in KINDS}
    got = {w: run_ranks(rank_streams, w, (main, q), device="cpu")
           for w in WORLDS}
    got["extras"] = run_ranks(
        rank_streams, 2, ({k: v for k, v in scenarios.items()
                           if k not in KINDS}, q), device="cpu")
    got["background"] = run_ranks(rank_background, 2, (main, q),
                                  device="cpu")
    return want, got


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stream_matches_jax_single_device(runs, world, kind, stage):
    want, got = runs
    np.testing.assert_array_equal(got[world][kind]["ids"][stage],
                                  want[kind][stage])


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", [e[0] for e in EXTRAS])
def test_sharded_stream_quantized_kernel_and_projection(runs, name, stage):
    """int8 tables and K1's cell-major live-map route (its plain version
    here) serve the masked sharded scan; so does a Reduce stage."""
    want, got = runs
    np.testing.assert_array_equal(got["extras"][name]["ids"][stage],
                                  want[name][stage])


@pytest.mark.parametrize("world", WORLDS)
def test_writes_while_sharded_and_compact_reshards(runs, world):
    """A write lands on the replicated leaves (the sharded base object is
    kept); a compaction re-lays it out; donation is refused on a
    streaming engine; metrics say sharded."""
    for kind in KINDS:
        r = runs[1][world][kind]
        assert r["refused"] and r["kept"] and r["relaid"] and r["sharded"]


@pytest.mark.parametrize("kind", KINDS)
def test_background_compaction_swaps_on_every_rank_at_once(runs, kind):
    """Each rank folds on its own worker thread: with rank 0's fold done
    and rank 1's held, a search swaps on no rank (the ids are the
    unswapped reference's); once both are done, one search swaps on
    both."""
    r = runs[1]["background"][kind]
    assert r["pending"]
    assert r["swaps"] == {"held": [0, 0], "swapped": [1, 1]}
    for stage in ("held", "swapped"):
        np.testing.assert_array_equal(r["ids"][stage], r["want"][stage])


@pytest.mark.parametrize("lut", LUTS)
@pytest.mark.parametrize("kind", ["pq", "opq"])
def test_local_scan_streaming_route_keeps_the_query_constant(kind, lut):
    """Fault F6: on the streaming route (``live`` given) the shard-local
    plain-PQ scan's scores are merged with the delta segment's exact
    distances, so they are the single-device streaming scan's, the
    per-query constant included (the JAX package's drop it). At one
    block of one rank the two scans return the same (d2, ids)."""
    from repro_torch.parallel.context import Mesh
    from repro_torch.parallel.engine import shard_stream
    from repro_torch.search import SearchEngine, ServeConfig, StreamConfig
    from repro_torch.search.registry import ScanParams, get_ops
    from repro_torch.search.segments import live_mask
    eng = SearchEngine(_data(), ServeConfig(
        **_config_kw(kind, lut), stream=StreamConfig(delta_capacity=64)),
        device="cpu")
    eng.delete(np.arange(0, 60, 7))
    store, frozen = eng.store, eng.frozen
    mesh = Mesh("data", 1, 0, None, "gloo", torch.device("cpu"))
    sbase = shard_stream(store, frozen, mesh)
    qr = torch.from_numpy(_queries())
    live = live_mask(store)
    p = ScanParams(nprobe=5, backend="jnp", lut_dtype=lut)
    ops = get_ops(kind)
    want = ops.stream_scan(store, frozen, qr, 64, live, p)
    got = ops.local_scan(sbase, qr, 64, p, 0, 0, live=live)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
