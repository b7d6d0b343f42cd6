"""The sharded layouts of the port against the JAX package's (twin of the
layout half of tests/test_sharded_serve.py): ``balance_cells``,
``posting_lists(shards=)`` and each kind's ``shard_payload`` at 1, 2, 3
and 8 shards leaf for leaf against JAX's on the same (bridged) state,
the per-rank blocks ``shard_engine`` keeps, the shard-aware builds'
pre-padded cells, ``donate`` / ``keep``, the engine's ordering rules and
``restore_resharded``. Layout is pure padding and slicing: no collective
runs, so a ``Mesh`` record with no process group stands in for each
rank. The same numpy inputs, made from a seed, go through both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.bridge import state_from_arrays  # noqa: E402
from repro_torch.parallel import Mesh, mesh_context, shard_engine  # noqa: E402
from repro_torch.parallel.sharding import engine_state_specs  # noqa: E402
from repro_torch.search import (SearchEngine, ServeConfig,  # noqa: E402
                                StreamConfig, balance_cells, build_engine,
                                get_ops)
from repro_torch.search import ivf as tivf  # noqa: E402
from repro_torch.search import ivfpq as tivfpq  # noqa: E402
from repro_torch.search.registry import CELLS, ROWS  # noqa: E402

N, DIM, K = 601, 32, 10
SHARDS = (1, 2, 3, 8)
SPECS = {"flat": "qpad8>rr64", "flat_corpus": "rr64",
         "ivf": "qpad8>ivf12x5>rr64", "pq": "qpad8>pq8x64>rr64",
         "opq": "qpad8>opq8x64>rr64", "ivfpq": "qpad8>ivf12x5>pq8x64>rr64"}


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _data(seed=0, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2
    lab = rng.integers(0, 12, n)
    return (centers[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _queries(nq=24):
    rng = np.random.default_rng(9)
    return (_data()[:nq] + 0.02 * rng.normal(size=(nq, DIM))).astype(
        np.float32)


def _mesh(size, rank=0):
    """A rank's mesh record; layout needs no process group."""
    return Mesh(axis="data", size=size, rank=rank, group=None,
                backend="gloo", device=torch.device("cpu"))


def _state_arrays(state):
    jax, _ = _jax()
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.fixture(scope="module")
def engines():
    """One JAX engine a spec over the same numpy corpus, and the port's
    state bridged from each."""
    from repro.core import MPADConfig
    from repro.search import build_engine
    out = {}
    for name, spec in SPECS.items():
        kw = dict(fit_sample=512)
        if spec.startswith("qpad"):
            kw["mpad"] = MPADConfig(m=8, iters=16)
        jeng = build_engine(_data(), spec, **kw)
        out[name] = (jeng, state_from_arrays(_state_arrays(jeng.state), spec,
                                             device="cpu"))
    return out


def _leaves(tree):
    """The tensors / arrays of a payload in field order (None kept)."""
    if tree is None or not isinstance(tree, tuple):
        return [tree]
    return list(tree)


@pytest.mark.parametrize("counts,shards", [
    ([600, 300, 150, 80, 40, 30, 20, 15] + [10] * 8, 4),
    ([5, 0, 9, 9, 1, 30, 2], 3),
    ([7] * 12, 8),
    ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], 2),
])
def test_balance_cells_matches_jax(counts, shards):
    from repro.search import balance_cells as jax_balance
    got = balance_cells(np.asarray(counts), shards)
    np.testing.assert_array_equal(got, np.asarray(jax_balance(
        np.asarray(counts), shards)))
    assert sorted(got.tolist()) == list(range(len(counts)))


@pytest.mark.parametrize("shards", SHARDS)
def test_posting_lists_with_shards_match_jax(shards):
    _, jnp = _jax()
    from repro.search.ivf import posting_lists as jax_posting
    assign = np.random.default_rng(shards).integers(0, 12, 300)
    got = tivf.posting_lists(torch.from_numpy(assign), 12, shards)
    want = np.asarray(jax_posting(jnp.asarray(assign), 12, shards))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[0] % shards == 0 and (got[12:] == -1).all()


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_shard_payload_matches_jax(engines, name, shards):
    """``shard_payload`` is JAX's leaf for leaf; the ranks' blocks
    (``shard_engine``) tile the padded layout, replicated leaves pass
    through by identity, ``n_real`` is the unpadded count."""
    from repro.search.registry import get_ops as jax_get_ops
    jeng, state = engines[name]
    kind = state.index.kind
    want = jax_get_ops(kind).shard_payload(jeng.state, shards)
    got = get_ops(kind).shard_payload(state, shards)
    if isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__
    for g, w in zip(_leaves(got), _leaves(want)):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    blocks = [shard_engine(state, _mesh(shards, r)) for r in range(shards)]
    specs = engine_state_specs(blocks[0])
    corpus = torch.cat([b.corpus for b in blocks])
    assert corpus.shape[0] % shards == 0
    np.testing.assert_array_equal(corpus[:N].numpy(), state.corpus.numpy())
    assert (corpus[N:] == 0).all()
    for b in blocks:
        assert b.n_real == N and b.index.kind == kind
    for i, (full, marker) in enumerate(zip(_leaves(got),
                                           _leaves(specs.index.payload))):
        parts = [_leaves(b.index.payload)[i] for b in blocks]
        if full is None:
            assert all(p is None for p in parts)
        elif marker in (ROWS, CELLS):
            np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                          full.numpy())
        else:
            assert all(p is full for p in parts)


@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
def test_shard_aware_builders_prepad_cells(kind):
    """``build_ivf`` / ``build_ivfpq(shards=)`` pad the cell axis up front
    (``shard_payload`` then adds nothing) and serve the unsharded build's
    ids; from JAX's k-means starting rows the lists equal JAX's."""
    jax, jnp = _jax()
    from repro.search import ivf as jivf
    from repro.search import ivfpq as jivfpq
    x = _data()
    q = torch.from_numpy(_queries())
    key = jax.random.key(1)
    init = torch.from_numpy(np.array(jax.random.choice(
        key, N, (12,), replace=False))).long()
    if kind == "ivf":
        plain = tivf.build_ivf(torch.from_numpy(x), 12, init=init)
        pre = tivf.build_ivf(torch.from_numpy(x), 12, init=init, shards=8)
        jpre = jivf.build_ivf(key, jnp.asarray(x), 12, shards=8)
        _, i1 = tivf.ivf_search(plain, q, K, nprobe=5)
        _, i2 = tivf.ivf_search(pre, q, K, nprobe=5)
    else:
        gen = torch.Generator().manual_seed(0)
        plain = tivfpq.build_ivfpq(torch.from_numpy(x), 12, 8, 64,
                                   device="cpu", coarse_init=init,
                                   generator=gen)
        gen = torch.Generator().manual_seed(0)
        pre = tivfpq.build_ivfpq(torch.from_numpy(x), 12, 8, 64,
                                 device="cpu", coarse_init=init,
                                 generator=gen, shards=8)
        jpre = jivfpq.build_ivfpq(key, jnp.asarray(x), 12, 8, 64, shards=8)
        assert pre.codes_cell.shape[0] == 16 == pre.bias_cell.shape[0]
        _, i1 = tivfpq.ivfpq_search(plain, q, K, nprobe=5)
        _, i2 = tivfpq.ivfpq_search(pre, q, K, nprobe=5)
    assert plain.lists.shape[0] == 12 and pre.lists.shape[0] == 16
    assert (pre.lists[12:] == -1).all()
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(pre.lists.numpy(), np.asarray(jpre.lists))


def test_balanced_cell_placement_improves_shard_mass():
    """Load-aware placement must beat the unbalanced layout on a skewed
    corpus without changing the ids served (as JAX's test)."""
    rng = np.random.default_rng(0)
    nlist, shards = 16, 4
    sizes = [600, 300, 150, 80, 40, 30, 20, 15] + [10] * 8
    centers = rng.normal(size=(16, DIM)) * 6
    x = np.concatenate([centers[i] + 0.1 * rng.normal(size=(s, DIM))
                        for i, s in enumerate(sizes)]).astype(np.float32)
    init = torch.from_numpy(np.cumsum([0] + sizes[:-1])).long()

    def build(balance):
        return tivfpq.build_ivfpq(
            torch.from_numpy(x), nlist, 8, 64, device="cpu",
            coarse_init=init, generator=torch.Generator().manual_seed(1),
            shards=shards, balance=balance)

    def imbalance(lists):
        per = lists.shape[0] // shards
        mass = [int((lists[s * per:(s + 1) * per] >= 0).sum())
                for s in range(shards)]
        return max(mass) - min(mass)

    bal, raw = build(True), build(False)
    assert imbalance(bal.lists) < imbalance(raw.lists)
    q = torch.from_numpy(x[:32] + 0.02 * rng.normal(size=(32, DIM)).astype(
        np.float32))
    _, i1 = tivfpq.ivfpq_search(bal, q, K, nprobe=8)
    _, i2 = tivfpq.ivfpq_search(raw, q, K, nprobe=8)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())


def test_shard_engine_requires_mesh(engines):
    with pytest.raises(RuntimeError, match="mesh"):
        shard_engine(engines["flat"][1])
    with mesh_context(_mesh(2)):
        assert shard_engine(engines["flat"][1]).corpus.shape[0] == 301


def test_shard_donate_releases_dense_buffers():
    """``shard(donate=True)``: every dense tensor is freed (emptied) or
    lives on, by identity, in the rank's sharded state, or is the caller's
    corpus; re-sharding and streaming raise; the reducer still works."""
    from repro_torch._tree import tree_leaves
    x = torch.from_numpy(_data())
    eng = build_engine(x, "qpad8>ivf12x5>pq8x64>rr64", device="cpu",
                       fit_sample=512)
    old = [t for t in tree_leaves((eng.state.corpus, eng.state.proj.params,
                                   eng.state.index.payload))]
    eng.shard(_mesh(2, 1), donate=True)
    s = eng.sharded_state
    placed = {id(t) for t in tree_leaves((s.corpus, s.proj.params,
                                          s.index.payload))}
    for t in old:
        assert t.numel() == 0 or id(t) in placed or t is x
    assert eng.state is None
    assert s.corpus.shape[0] == 301 and s.n_real == N
    with pytest.raises(RuntimeError, match="donate"):
        eng.shard(_mesh(2, 1))
    with pytest.raises(RuntimeError, match="BEFORE shard"):
        eng.streaming(StreamConfig(delta_capacity=64))
    with pytest.raises(RuntimeError, match="donate"):
        eng.save("unused-dir")
    assert eng.reducer(x[:5]).shape == (5, 8)


def test_shard_donate_spares_user_owned_corpus():
    x = torch.from_numpy(_data())
    eng = SearchEngine(x, ServeConfig(target_dim=None, index="flat"),
                       device="cpu")
    eng.shard(_mesh(2, 0), donate=True)
    assert x.numel() == N * DIM and torch.isfinite(x).all()
    assert eng.state is None and eng.sharded_state.corpus.shape[0] == 301


def test_streaming_order_rules():
    """``streaming()`` before ``shard()``; a streaming engine refuses
    donation (its dense store is the write path)."""
    eng = SearchEngine(_data(), "ivf12x5>rr64", device="cpu")
    eng.shard(_mesh(2, 0))
    with pytest.raises(RuntimeError, match="BEFORE shard"):
        eng.streaming(StreamConfig(delta_capacity=64))
    eng = SearchEngine(_data(), "ivf12x5>rr64", device="cpu").streaming(
        StreamConfig(delta_capacity=64))
    with pytest.raises(ValueError, match="donate"):
        eng.shard(_mesh(1), donate=True)
    eng.shard(_mesh(2, 1))
    base = eng._stream_sharded_base
    assert base.n_real == eng.store.corpus.shape[0]
    # the base is a copy: compaction writes the store in place
    assert base.corpus.data_ptr() != eng.store.corpus.data_ptr()


def test_restore_resharded_keeps_each_ranks_block(tmp_path):
    from repro_torch.runtime import restore_resharded, save_checkpoint
    tree = {"rows": torch.arange(24.0).reshape(8, 3),
            "cells": torch.arange(8).reshape(4, 2), "rep": torch.ones(5)}
    path = save_checkpoint(str(tmp_path), 1, tree)
    splits = {"rows": "rows", "cells": "cells", "rep": "replicated"}
    parts = [restore_resharded(path, tree, splits, _mesh(2, r))
             for r in range(2)]
    for key in ("rows", "cells"):
        assert torch.equal(torch.cat([p[key] for p in parts]), tree[key])
    assert all(torch.equal(p["rep"], tree["rep"]) for p in parts)
    with pytest.raises(ValueError, match="multiple"):
        restore_resharded(path, tree, splits, _mesh(3, 0))


def test_nccl_mesh_refuses_more_shards_than_cards(monkeypatch):
    """One NCCL rank a card: more shards than cards raises, naming the
    gloo route (``--mesh host``)."""
    from repro_torch.launch.mesh import make_serving_mesh
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--mesh host"):
        make_serving_mesh(2, backend="nccl")
    with pytest.raises(RuntimeError, match="need 3 ranks"):
        make_serving_mesh(3, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        make_serving_mesh(2, backend="mpi")
