"""Port parity for the streaming engine (repro_torch.search.segments,
stream, the registry's streaming hooks, durability.policy and the
SearchEngine write methods).

One sequence of operations runs on one store built by the JAX package and
carried across by ``bridge.stream_from_arrays``: through JAX's jitted
``upsert_fn`` / ``delete_fn`` / ``compact_fn`` / ``grow_store`` and
through the port's. It has in-batch duplicates, overwrites of base and
delta rows, a delete of base, delta and absent ids, a re-upsert after a
delete, a delta overflow, a compaction that overflows a cell's slack and
the row capacity (all-or-nothing), a grow, and a compaction. After every
operation the stores' tensors and ``stream_search_fn``'s external ids
must equal JAX's, for the flat, ivf, pq, opq and ivfpq kinds (f32 and
int8, with and without a reducer; ivfpq also on K1's route, its plain
version here). After the final compaction the ids equal those of a
search over ``rebuild_state(frozen, survivors)``. Then twins of
tests/test_stream.py's engine cases, and the maintenance policy's
decisions against JAX's on the same observations.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.bridge import stream_from_arrays  # noqa: E402
from repro_torch.core.mpad import MPADConfig  # noqa: E402
from repro_torch.kernels.pq_adc import ops as adc_ops  # noqa: E402
from repro_torch.search import (SearchEngine, ServeConfig,  # noqa: E402
                                StreamConfig, compact_fn, delete_fn,
                                grow_store, rebuild_state, search_fn,
                                stream_search_fn, upsert_fn)
from repro_torch.search import segments  # noqa: E402
from repro_torch.search.durability import (Decision,  # noqa: E402
                                           MaintenancePolicy, PolicyConfig)

N, DIM, K = 600, 32, 10
CAP, SLACK, ROWS = 16, 4, N + 16          # delta, cell slack, row capacity
WB = 32                                   # padded write batch

# (case, spec, search lut, search backend)
CASES = [
    ("flat", "flat>rr128", "f32", "jnp"),
    ("flat-qpad", "qpad8>flat>rr128", "f32", "jnp"),
    ("ivf", "ivf12x12>rr128", "f32", "jnp"),
    ("ivf-qpad", "qpad8>ivf12x12>rr128", "f32", "jnp"),
    ("pq-int8", "pq8x64:i8>rr128", "int8", "jnp"),
    ("opq", "opq8x64>rr128", "f32", "jnp"),
    ("ivfpq", "ivf12x12>pq8x64>rr128", "f32", "jnp"),
    ("ivfpq-int8", "ivf12x12>pq8x64:i8>rr128", "int8", "jnp"),
    ("ivfpq-int8-k1", "ivf12x12>pq8x64:i8>rr128", "int8", "kernel"),
    ("ivfpq-int8-qpad", "qpad8>ivf12x12>pq8x64:i8>rr128", "int8", "jnp"),
]
# float leaves the port computes itself (projections, bias terms): their
# sums run in another order than XLA's
COMPUTED = ("reduced", "delta_reduced", "bias", "bias_cell")


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _data(seed=0, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2
    lab = rng.integers(0, 12, n)
    return (centers[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _queries(nq=16):
    rng = np.random.default_rng(9)
    return (_data()[:nq] + 0.02 * rng.normal(size=(nq, DIM))).astype(
        np.float32)


def _ops():
    """The operation sequence: ("upsert", ids, vectors) / ("delete", ids)
    / ("compact",) / ("grow",), ids padded with -1 to WB."""
    rng = np.random.default_rng(1)
    x = _data()

    def vec(n, near=None):
        base = x[near] if near is not None else rng.normal(size=(n, DIM))
        return (base + 0.05 * rng.normal(size=(n, DIM))).astype(np.float32)

    near3 = np.full(20, 3)                    # rows in row 3's cell
    return [
        # in-batch duplicates (later rows win), a base overwrite, a pad
        ("upsert", [N, N + 1, N, N + 2, -1, 5, N + 1], vec(7)),
        # a delta hole, a base row, an absent id
        ("delete", [N + 2, 7, 10 ** 6]),
        # re-upsert after delete, overwrite a base and a delta row
        ("upsert", [N + 2, 3, N], vec(3)),
        ("compact",),
        # 20 new ids into a delta of 16: 4 dropped
        ("upsert", list(range(N + 10, N + 30)), vec(20, near3)),
        ("delete", [N + 12, 0, 1]),
        # 15 live rows into one cell (4 slots of slack) and past the row
        # capacity (605 + 15 > 616): the fold overflows, all-or-nothing
        ("compact",),
        ("grow",),
        ("compact",),
        ("upsert", list(range(N + 40, N + 52)), vec(12, near3[:12])),
        ("delete", [N + 41, N + 11]),
        ("compact",),
        ("upsert", [N + 60, N + 61, 4], vec(3)),
    ]


def _pad(ids):
    ids = np.asarray(ids, np.int64)
    return np.concatenate([ids, np.full(WB - ids.shape[0], -1)])


def _pad_vecs(v):
    return np.concatenate([v, np.zeros((WB - v.shape[0], DIM), np.float32)])


def _jax_store_arrays(store, frozen):
    jax, _ = _jax()
    flat, _ = jax.tree_util.tree_flatten_with_path(
        {"store": store, "frozen": frozen})
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_same_store(jstore, tstore, where):
    for f in segments.StreamStore._fields:
        j, t = getattr(jstore, f), getattr(tstore, f)
        assert (j is None) == (t is None), (where, f)
        if j is None:
            continue
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape, (where, f, j.shape, t.shape)
        if f in COMPUTED:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{where}: {f}")
        else:
            np.testing.assert_array_equal(t, j.astype(t.dtype),
                                          err_msg=f"{where}: {f}")


@pytest.fixture(scope="module")
def jax_fns():
    jax, _ = _jax()
    from repro.search import segments as jseg
    from repro.search.serve import _SEARCH_STATICS
    from repro.search.stream import stream_search_fn as jstream
    return {"upsert": jax.jit(jseg.upsert_fn),
            "delete": jax.jit(jseg.delete_fn),
            "compact": jax.jit(jseg.compact_fn),
            "grow": jseg.grow_store,
            "search": jax.jit(jstream, static_argnames=_SEARCH_STATICS),
            "rebuild": jseg.rebuild_state}


def _jax_engine(spec):
    from repro.core import MPADConfig as JConfig
    from repro.search import build_engine as jax_build_engine
    from repro.search import StreamConfig as JStreamConfig
    kw = {"mpad": JConfig(m=8, iters=16)} if spec.startswith("qpad") else {}
    return jax_build_engine(
        _data(), spec, fit_sample=512,
        stream=JStreamConfig(delta_capacity=CAP, cell_slack=SLACK,
                             row_capacity=ROWS), **kw)


_BUILT = {}


def _built(spec):
    """One JAX build per spec (both ivfpq int8 cases share theirs)."""
    if spec not in _BUILT:
        _BUILT[spec] = _jax_engine(spec)
    return _BUILT[spec]


@pytest.mark.parametrize("case,spec,lut,backend", CASES,
                         ids=[c[0] for c in CASES])
def test_same_operations_same_store_and_ids(jax_fns, monkeypatch, case,
                                            spec, lut, backend):
    _, jnp = _jax()
    jeng = _built(spec)
    js, jf = jeng.store, jeng.frozen
    ts, tf = stream_from_arrays(_jax_store_arrays(js, jf), spec,
                                device="cpu")
    _assert_same_store(js, ts, "bridged")
    routes = []
    entry = adc_ops.pq_adc_cells_topk

    def cells_topk(*a, cell_len=None, live=None, **kw):
        routes.append((cell_len is not None, live is not None))
        return entry(*a, cell_len=cell_len, live=live, **kw)

    monkeypatch.setattr(adc_ops, "pq_adc_cells_topk", cells_topk)
    q = _queries()
    knobs = dict(nprobe=12, rerank=128, lut_dtype=lut)
    dropped = []
    for step, op in enumerate(_ops()):
        where = f"{case} op {step} {op[0]}"
        if op[0] == "upsert":
            ids, vecs = _pad(op[1]), _pad_vecs(op[2])
            js, jd = jax_fns["upsert"](js, jf, jnp.asarray(ids, jnp.int32),
                                       jnp.asarray(vecs))
            ts, td = upsert_fn(ts, tf, torch.from_numpy(ids),
                               torch.from_numpy(vecs))
            assert int(td) == int(jd), where
            dropped.append(int(td))
        elif op[0] == "delete":
            ids = _pad(op[1])
            js = jax_fns["delete"](js, jnp.asarray(ids, jnp.int32))
            ts = delete_fn(ts, torch.from_numpy(ids))
        elif op[0] == "compact":
            js, jd = jax_fns["compact"](js, jf)
            ts, td = compact_fn(ts, tf)
            assert int(td) == int(jd), where
            dropped.append(-int(td))
        else:
            js = jax_fns["grow"](js, row_extra=4 * CAP, cell_extra=CAP)
            ts = grow_store(ts, row_extra=4 * CAP, cell_extra=CAP)
        _assert_same_store(js, ts, where)
        dj, ij = jax_fns["search"](js, jf, jnp.asarray(q), K, **knobs)
        dt, it = stream_search_fn(ts, tf, torch.from_numpy(q), K,
                                  backend=backend, **knobs)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij),
                                      err_msg=where)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-5, err_msg=where)
    # the delta overflowed (op 4) and a compaction overflowed (op 6)
    assert dropped[3] == 4 and dropped[4] == -15, dropped
    # the masked scan took K1's cell-major entry once a search, on the
    # cells' fills with a live byte a slot (its plain version on the CPU)
    assert routes == ([(True, True)] * len(_ops()) if backend == "kernel"
                      else [])
    # fold the rest; then the ids of a rebuild over the survivors
    ts, td = compact_fn(ts, tf)
    assert int(td) == 0 and int(ts.delta_count) == 0
    live = segments.live_mask(ts)
    surv, ext = ts.corpus[live], ts.row_ids[live]
    assert sorted(ext.tolist()) == sorted(_live_ids(js))
    oracle = rebuild_state(tf, surv)
    _, ir = search_fn(oracle, torch.from_numpy(q), K, backend=backend,
                      **knobs)
    _, is_ = stream_search_fn(ts, tf, torch.from_numpy(q), K,
                              backend=backend, **knobs)
    np.testing.assert_array_equal(np.sort(is_.numpy(), axis=1),
                                  np.sort(ext[ir].numpy(), axis=1))


def _live_ids(jstore):
    """External ids JAX's store serves: live base rows and live delta
    slots."""
    row_ids = np.asarray(jstore.row_ids)
    live = (row_ids >= 0) & ~np.asarray(jstore.dead)
    dids = np.asarray(jstore.delta_ids)
    alive = (np.arange(dids.shape[0]) < int(jstore.delta_count)) & (dids >= 0)
    return [int(i) for i in row_ids[live]] + [int(i) for i in dids[alive]]


# --- twins of tests/test_stream.py: the port's own engines ----------------

def _cfg(index, lut="f32", target_dim=None, **stream_kw):
    stream_kw.setdefault("delta_capacity", 64)
    kw = dict(target_dim=target_dim, rerank=128, index=index,
              mpad=MPADConfig(m=8, iters=16) if target_dim else None,
              fit_sample=512, stream=StreamConfig(**stream_kw))
    if index in ("ivf", "ivfpq"):
        kw.update(nlist=12, nprobe=12)
    if index in ("pq", "ivfpq"):
        kw.update(pq_subspaces=8, pq_centroids=64, lut_dtype=lut)
    return ServeConfig(**kw)


def _engine(index, **kw):
    return SearchEngine(_data(), _cfg(index, **kw), device="cpu")


@pytest.mark.parametrize("index", ("flat", "ivf", "pq", "ivfpq"))
def test_fresh_stream_matches_static(index):
    """Before any write, the streaming engine is the static engine."""
    eng = _engine(index)
    static = SearchEngine(_data(), dataclasses.replace(eng.config,
                                                       stream=None),
                          device="cpu")
    q = _queries()
    d1, i1 = eng.search(q, K)
    d2, i2 = static.search(q, K)
    assert torch.equal(i1, i2)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), atol=1e-5)


@pytest.mark.parametrize("index", ("flat", "ivfpq"))
def test_upsert_visible_immediately_and_exact(index):
    eng = _engine(index)
    q = _queries()
    new_ids = np.arange(N, N + q.shape[0])
    eng.upsert(new_ids, q)
    d, ids = eng.search(q, K)
    # each query's own copy wins at distance ~0, served from the delta
    np.testing.assert_array_equal(ids[:, 0].numpy(), new_ids)
    assert float(d[:, 0].max()) < 1e-3


def test_upsert_overwrites_by_id():
    eng = _engine("ivfpq")
    q = _queries(4)
    far = np.full((4, DIM), 100.0, np.float32)
    eng.upsert(np.arange(N, N + 4), q)            # near the queries
    eng.upsert(np.arange(N, N + 4), far)          # same ids, far away
    _, ids = eng.search(q, K)
    assert not np.isin(np.arange(N, N + 4), ids[:, 0].numpy()).any()
    # overwriting a BASE id tombstones the base copy
    base_id = int(eng.search(q[:1], 1)[1][0, 0])
    eng.upsert(np.array([base_id]), far[:1])
    _, ids2 = eng.search(q[:1], K)
    assert base_id not in ids2[0].tolist()


def test_delete_hides_base_and_delta_rows():
    eng = _engine("ivfpq")
    q = _queries(4)
    top = eng.search(q, K)[1][:, 0].numpy()
    eng.delete(top)                               # base rows
    assert not np.isin(top, eng.search(q, K)[1].numpy()).any()
    eng.upsert(np.arange(N, N + 4), q)            # delta rows
    eng.delete(np.arange(N, N + 4))
    _, final = eng.search(q, K)
    assert not np.isin(np.arange(N, N + 4), final.numpy()).any()
    eng.delete(np.array([10 ** 6]))               # an absent id: no-op
    assert torch.equal(final, eng.search(q, K)[1])


def test_reupsert_after_delete_resurfaces():
    eng = _engine("flat")
    q = _queries(2)
    eng.upsert(np.array([N, N + 1]), q)
    eng.delete(np.array([N, N + 1]))
    eng.upsert(np.array([N, N + 1]), q)
    np.testing.assert_array_equal(eng.search(q, K)[1][:, 0].numpy(),
                                  [N, N + 1])


def _apply_random_ops(eng, rng, steps=8):
    """Random interleaving of upserts (new ids and overwrites) and deletes;
    returns the surviving {id: vector} map."""
    alive = {i: _data()[i] for i in range(N)}
    next_id = N
    for _ in range(steps):
        if rng.rand() < 0.6:
            ids, vecs = [], []
            for _ in range(rng.randint(1, 20)):
                if alive and rng.rand() < 0.3:
                    i = int(rng.choice(list(alive)))
                else:
                    i, next_id = next_id, next_id + 1
                v = rng.randn(DIM).astype(np.float32)
                ids.append(i)
                vecs.append(v)
                alive[i] = v
            eng.upsert(np.array(ids), np.stack(vecs))
        else:
            ids = [int(i) for i in rng.choice(
                list(alive), size=min(rng.randint(1, 10), len(alive)),
                replace=False)]
            for i in ids:
                del alive[i]
            eng.delete(np.array(ids))
    return alive


@pytest.mark.parametrize("index,lut,target_dim", [
    ("flat", "f32", None), ("ivf", "f32", None), ("pq", "f32", None),
    ("ivfpq", "f32", None), ("flat", "f32", 8), ("ivfpq", "f32", 8),
    ("ivfpq", "int8", None), ("ivfpq", "int8", 8), ("pq", "int8", None),
])
@pytest.mark.parametrize("seed", (3, 7))
def test_interleaved_ops_then_compact_equals_rebuild(index, lut, target_dim,
                                                     seed):
    """After compaction, streaming search returns the ids of a rebuild over
    the surviving rows with the same frozen quantizers."""
    eng = _engine(index, lut=lut, target_dim=target_dim)
    alive = _apply_random_ops(eng, np.random.RandomState(seed))
    eng.compact()
    assert int(eng.store.delta_count) == 0
    surv_ids = np.array(sorted(alive))
    oracle = rebuild_state(eng.frozen,
                           np.stack([alive[i] for i in surv_ids]),
                           index=index)
    coded = index in ("pq", "ivfpq")
    q = _queries()
    d_r, i_r = search_fn(oracle, torch.from_numpy(q), K, nprobe=12,
                         rerank=128, lut_dtype=lut if coded else "f32")
    d_s, i_s = eng.search(q, K)
    np.testing.assert_array_equal(np.sort(i_s.numpy(), axis=1),
                                  np.sort(surv_ids[i_r.numpy()], axis=1))
    np.testing.assert_allclose(np.sort(d_s.numpy(), axis=1),
                               np.sort(d_r.numpy(), axis=1), atol=1e-4)


def test_interleaved_workload_never_grows():
    """An interleaved upsert / delete / search workload across several
    auto-compactions stays inside the provisioned capacity (no grow)."""
    n, d = 4096, DIM
    rng = np.random.RandomState(0)
    centers = rng.randn(64, d) * 2
    x = (centers[rng.randint(0, 64, n)]
         + 0.3 * rng.randn(n, d)).astype(np.float32)
    eng = SearchEngine(x, ServeConfig(
        target_dim=None, rerank=64, index="ivfpq", nlist=64, nprobe=8,
        pq_subspaces=8, pq_centroids=64,
        stream=StreamConfig(delta_capacity=128, write_bucket=64,
                            row_capacity=n + 4096, cell_slack=2048)),
        device="cpu")
    q = x[:64]
    for step in range(20):                     # crosses the auto-compact
        eng.upsert(np.arange(n + 100 + 32 * step, n + 132 + 32 * step),
                   rng.randn(32, d).astype(np.float32))
        eng.delete(rng.randint(0, n, size=8))
        assert eng.search(q, K)[1].shape == (64, K)
    assert eng.grow_count == 0 and eng.counters["compactions"] >= 4


def test_write_batches_pad_to_the_write_bucket(monkeypatch):
    """Ragged write batches pad to power-of-two buckets floored at
    write_bucket, so the write path sees few shapes."""
    seen = []
    real = segments.upsert_fn

    def spy(store, frozen, ids, vectors):
        seen.append(tuple(ids.shape))
        return real(store, frozen, ids, vectors)

    monkeypatch.setattr(segments, "upsert_fn", spy)
    eng = _engine("flat", write_bucket=32, delta_capacity=256)
    rng = np.random.RandomState(0)
    for b in (1, 5, 17, 32, 33):
        eng.upsert(np.arange(N, N + b), rng.randn(b, DIM).astype(np.float32))
    assert seen == [(32,)] * 4 + [(64,)]


def test_delta_overflow_auto_compacts():
    """One upsert larger than the delta streams through in chunks with
    compactions in between; nothing is lost."""
    eng = _engine("ivfpq", delta_capacity=32)
    vecs = np.random.RandomState(1).randn(100, DIM).astype(np.float32)
    eng.upsert(np.arange(N, N + 100), vecs)
    np.testing.assert_array_equal(eng.search(vecs[:8], 1)[1][:, 0].numpy(),
                                  np.arange(N, N + 8))


def test_compact_overflow_grows_and_stays_correct():
    """Under-provisioned capacity: compaction detects the overflow, grows,
    retries, and serves what a generously provisioned engine serves."""
    vecs = np.random.RandomState(2).randn(80, DIM).astype(np.float32)
    tight = _engine("ivfpq", delta_capacity=64, row_capacity=N + 8,
                    cell_slack=2)
    roomy = _engine("ivfpq", delta_capacity=64, row_capacity=N + 512,
                    cell_slack=512)
    for eng in (tight, roomy):
        eng.upsert(np.arange(N, N + 80), vecs)
        eng.compact()
    assert tight.grow_count >= 1 and roomy.grow_count == 0
    q = _queries()
    assert torch.equal(tight.search(q, K)[1], roomy.search(q, K)[1])


def test_streaming_engine_releases_dense_state():
    """The store owns fresh copies of every database tensor, so the dense
    state is released; the frozen quantizers stay the build's."""
    eng = SearchEngine(_data(), dataclasses.replace(_cfg("ivfpq"),
                                                    stream=None),
                       device="cpu")
    cents = eng.state.index.payload.centroids
    corpus = eng.state.corpus
    eng.streaming(StreamConfig(delta_capacity=64))
    assert eng.state is None
    assert eng.frozen.centroids is cents
    assert eng.store.corpus.data_ptr() != corpus.data_ptr()
    assert eng.search(_queries(4), K)[1].shape == (4, K)
    with pytest.raises(RuntimeError, match="already streaming"):
        eng.streaming()


def test_upsert_fn_reports_dropped_on_full_delta():
    """The raw write API reports overflow instead of losing rows
    silently."""
    eng = _engine("flat", delta_capacity=4)
    ids = torch.arange(N + 100, N + 108)
    vecs = torch.from_numpy(np.random.RandomState(0).randn(8, DIM).astype(
        np.float32))
    store, dropped = upsert_fn(eng.store, eng.frozen, ids, vecs)
    assert int(dropped) == 4 and int(store.delta_count) == 4


def test_stream_pq_kernel_backend_rejected():
    for index in ("pq", "opq"):
        with pytest.raises(ValueError, match="pq_backend"):
            ServeConfig(index=index, pq_backend="kernel",
                        stream=StreamConfig())
    eng = _engine("pq")
    with pytest.raises(ValueError, match="backend='jnp'"):
        stream_search_fn(eng.store, eng.frozen, torch.from_numpy(
            _queries()), K, rerank=128, backend="kernel")


def test_streamconfig_validation():
    with pytest.raises(ValueError, match="delta_capacity"):
        StreamConfig(delta_capacity=0)
    with pytest.raises(ValueError, match="compact_threshold"):
        StreamConfig(compact_threshold=0.0)
    with pytest.raises(ValueError, match="write_bucket"):
        StreamConfig(write_bucket=0)
    with pytest.raises(ValueError, match="cell_slack"):
        StreamConfig(cell_slack=0)
    with pytest.raises(TypeError, match="PolicyConfig"):
        StreamConfig(policy={"tombstone_density": 0.5})


def test_write_api_requires_stream_config():
    eng = SearchEngine(_data(), ServeConfig(target_dim=None), device="cpu")
    with pytest.raises(RuntimeError, match="read-only"):
        eng.upsert(np.array([0]), np.zeros((1, DIM), np.float32))
    with pytest.raises(RuntimeError, match="read-only"):
        eng.delete(np.array([0]))
    with pytest.raises(RuntimeError, match="read-only"):
        eng.compact()


def test_ivfpq_kernel_backend_streams():
    """The kernel backend serves the tombstone-masked scan (K1's
    cell-major entry on the candidate ids; its plain version here) with
    the plain route's ids."""
    kern = SearchEngine(_data(), dataclasses.replace(
        _cfg("ivfpq"), pq_backend="kernel"), device="cpu")
    ref = _engine("ivfpq")
    vecs = np.random.RandomState(3).randn(16, DIM).astype(np.float32)
    for eng in (kern, ref):
        eng.upsert(np.arange(N, N + 16), vecs)
        eng.delete(np.arange(0, 20, 2))
    q = _queries(8)
    assert torch.equal(kern.search(q, K)[1], ref.search(q, K)[1])


# --- background compaction, vacuum, quantizer rebuild ------------------------

def test_background_compaction_gives_the_blocking_ids():
    """begin_compact folds a copy on the worker thread while searches and
    writes continue; after finish_compact the ids equal those of the same
    writes with a blocking compaction."""
    rng = np.random.RandomState(4)
    first = rng.randn(40, DIM).astype(np.float32)
    later = rng.randn(10, DIM).astype(np.float32)
    q = _queries()
    bg, blocking = _engine("ivfpq"), _engine("ivfpq")
    for eng in (bg, blocking):
        eng.upsert(np.arange(N, N + 40), first)
        eng.delete(np.arange(0, 10))
    bg.begin_compact()
    assert bg.search(q, K)[1].shape == (16, K)       # serves meanwhile
    bg.upsert(np.arange(N + 100, N + 110), later)    # the tail
    bg.delete(np.array([N + 3, N + 101]))
    bg.finish_compact()
    blocking.compact()
    blocking.upsert(np.arange(N + 100, N + 110), later)
    blocking.delete(np.array([N + 3, N + 101]))
    assert bg.counters["swaps"] == blocking.counters["swaps"] == 1
    assert bg._delta_used == 10
    assert torch.equal(bg.search(q, K)[1], blocking.search(q, K)[1])
    bg.close()


def test_background_compact_config_auto_folds_off_thread():
    eng = _engine("flat", delta_capacity=32, background_compact=True)
    vecs = np.random.RandomState(5).randn(60, DIM).astype(np.float32)
    for b in range(0, 60, 12):
        eng.upsert(np.arange(N + b, N + b + 12), vecs[b:b + 12])
    eng.finish_compact()
    assert eng.counters["compactions"] >= 1
    np.testing.assert_array_equal(eng.search(vecs[:8], 1)[1][:, 0].numpy(),
                                  np.arange(N, N + 8))
    eng.close()


def test_vacuum_keeps_the_survivors_ids():
    eng = _engine("ivfpq")
    rng = np.random.RandomState(6)
    eng.upsert(np.arange(N, N + 20), rng.randn(20, DIM).astype(np.float32))
    eng.delete(np.arange(0, 200, 3))
    q = _queries()
    before = eng.search(q, K)[1]
    eng.vacuum()
    assert eng.counters["vacuums"] == 1
    assert not bool(eng.store.dead.any())
    assert int(eng.store.n_rows) == N - 67 + 20
    assert torch.equal(eng.search(q, K)[1], before)


def test_policy_vacuums_dense_tombstones():
    eng = _engine("flat", policy=PolicyConfig(tombstone_density=0.1,
                                              tombstone_min_dead=16))
    eng.delete(np.arange(0, 50))
    assert eng.counters["vacuums"] == 0
    eng.delete(np.arange(50, 70))
    assert eng.counters["vacuums"] == 1 and not bool(eng.store.dead.any())


def test_rebuild_quantizers_keeps_external_ids():
    eng = _engine("ivfpq")
    rng = np.random.RandomState(7)
    vecs = rng.randn(8, DIM).astype(np.float32)
    eng.upsert(np.arange(N, N + 8), vecs)
    eng.delete(np.arange(0, 8))
    eng.rebuild_quantizers()
    assert eng.counters["rebuilds"] == 1 and eng.config.seed == 1
    np.testing.assert_array_equal(eng.search(vecs, 1)[1][:, 0].numpy(),
                                  np.arange(N, N + 8))
    assert not np.isin(np.arange(8), eng.search(_data()[:8], K)[1]).any()


# --- the maintenance policy against JAX's -----------------------------------

def test_policy_decisions_match_jax():
    """The same observations through both packages' MaintenancePolicy
    give the same decisions, reasons, params and stats."""
    from repro.search.durability import policy as jpol
    cfgs = [dict(), dict(grow_headroom=1.5), dict(auto_rebuild=True,
                                                  drift_ratio=2.0,
                                                  drift_min_rows=8),
            dict(recall_floor=0.9, recall_min_samples=2)]
    for kw in cfgs:
        tp = MaintenancePolicy(PolicyConfig(**kw))
        jp = jpol.MaintenancePolicy(jpol.PolicyConfig(**kw))
        seq = [("build", 0.5), ("delete", 10, 600), ("encode", 0.6, 4),
               ("post", 100, 16, 0.0), ("delete", 200, 600),
               ("encode", 2.5, 16), ("recall", 0.8, 10), ("recall", 0.7, 10),
               ("post", 10, 16, 0.1), ("post", 10, 16, 5.0),
               ("encode", 0.0, 0), ("post", 30, 16, 0.0)]
        for ev in seq:
            outs = []
            for p in (tp, jp):
                if ev[0] == "build":
                    outs.append(p.observe_build_error(ev[1]))
                elif ev[0] == "encode":
                    outs.append(p.observe_encode_error(ev[1], ev[2]))
                elif ev[0] == "recall":
                    outs.append(p.observe_recall(ev[1], ev[2]))
                elif ev[0] == "delete":
                    outs.append(p.decide_delete(dead=ev[1],
                                                allocated=ev[2]))
                else:
                    outs.append(p.decide_post_compact(
                        free_rows=ev[1], delta_capacity=ev[2],
                        noise_floor=ev[3]))
            t, j = outs
            if isinstance(t, Decision):
                assert (t.kind, t.reason, t.params) == (j.kind, j.reason,
                                                        j.params), (kw, ev)
            assert tp.stats() == jp.stats(), (kw, ev)
    with pytest.raises(ValueError, match="drift_ratio"):
        PolicyConfig(drift_ratio=1.0)


# --- K1's masked route on the card ------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
def test_cuda_masked_scan_takes_the_cand_route(lut_dtype):
    """On the card a streaming ivfpq search with tombstones and delta rows
    launches K1's cell-major entry on the cand route once a search, with
    the plain route's ids (int8 d2 bit-equal in the scan)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.search import ivfpq as tivfpq
    cfg = dataclasses.replace(_cfg("ivfpq", lut=lut_dtype),
                              pq_backend="kernel")
    eng = SearchEngine(_data(), cfg, device="cuda")
    ref = SearchEngine.from_store(eng.store, eng.frozen, dataclasses.replace(
        cfg, pq_backend="jnp"))
    vecs = np.random.RandomState(8).randn(16, DIM).astype(np.float32)
    eng.upsert(np.arange(N, N + 16), vecs)
    eng.delete(np.arange(0, 40, 2))
    eng.compact()
    eng.upsert(np.arange(N + 20, N + 30), vecs[:10])
    eng.delete(np.array([N + 1, N + 21]))
    ref.store = eng.store
    q = torch.from_numpy(_queries()).cuda()
    c0 = adc_ops.pq_adc_cells_topk.launches
    _, ik = eng.search(q, K)
    torch.cuda.synchronize()
    assert adc_ops.pq_adc_cells_topk.launches == c0 + 1
    assert torch.equal(ik, ref.search(q, K)[1])
    st, fr = eng.store, eng.frozen
    live = segments.live_mask(st)
    args = (fr.centroids, st.lists, st.codes_cell, st.bias_cell, fr.lut_w,
            fr.cbnorm, fr.codebooks, q, 128, 12)
    dk, sk = tivfpq.ivfpq_adc_scan(*args, backend="kernel",
                                   lut_dtype=lut_dtype, live=live)
    dp, sp = tivfpq.ivfpq_adc_scan(*args, backend="jnp",
                                   lut_dtype=lut_dtype, live=live)
    assert torch.equal(sk, sp)
    if lut_dtype == "int8":
        assert torch.equal(dk, dp)


@pytest.mark.gpu
def test_cuda_background_compaction_swaps_a_complete_store():
    """On the card the fold runs on the worker thread in the caller's
    stream; the swapped store serves the blocking route's ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(_cfg("ivfpq", lut="int8"), pq_backend="kernel")
    bg = SearchEngine(_data(), cfg, device="cuda")
    blocking = SearchEngine(_data(), cfg, device="cuda")
    vecs = torch.from_numpy(np.random.RandomState(9).randn(40, DIM).astype(
        np.float32)).cuda()
    q = torch.from_numpy(_queries()).cuda()
    for eng in (bg, blocking):
        eng.upsert(torch.arange(N, N + 40), vecs)
    bg.begin_compact()
    for _ in range(5):
        bg.search(q, K)
    bg.finish_compact()
    blocking.compact()
    assert torch.equal(bg.search(q, K)[1], blocking.search(q, K)[1])
    bg.close()
