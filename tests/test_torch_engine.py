"""Port parity for the whole slice: a JAX QPAD -> IVF-PQ engine carried
across by repro_torch.bridge serves the same ids in the port, the port's
own build reaches the JAX engine's recall, and the spec grammar agrees."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import MPADConfig as JConfig  # noqa: E402
from repro.search import build_engine as jax_build_engine  # noqa: E402
from repro.search import format_spec as jax_format_spec  # noqa: E402
from repro.search import parse_spec as jax_parse_spec  # noqa: E402
from repro.search.knn import knn_search  # noqa: E402
from repro_torch.bridge import state_from_arrays  # noqa: E402
from repro_torch.core import MPADConfig  # noqa: E402
from repro_torch.search import (BuildInits, SearchEngine,  # noqa: E402
                                build_engine, config_from_spec, format_spec,
                                knn_scan, masked_topk, parse_spec,
                                recall_at_k)

SPEC = "qpad16>ivf32x4>pq8x256:i8>rr32"
N, D = 3000, 64
BATCHES = (1, 8, 64, 256)


def _clustered(seed, n, d=D, n_clusters=24):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 2.0
    lab = rng.integers(0, n_clusters, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def engines():
    x = _clustered(0, N)
    q = _clustered(0, N + 256)[N:]                 # held out, same clusters
    jeng = jax_build_engine(x, SPEC, mpad=JConfig(m=16, iters=8),
                            fit_sample=1024)
    flat, _ = jax.tree_util.tree_flatten_with_path(jeng.state)
    arrays = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    state = state_from_arrays(arrays, SPEC, device="cpu")
    return x, q, jeng, arrays, state


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("batch", BATCHES)
def test_carried_engine_returns_jax_ids(engines, lut_dtype, batch):
    x, q, jeng, _, state = engines
    jeng.config = dataclasses.replace(jeng.config, lut_dtype=lut_dtype)
    dj, ij = jeng.search(q[:batch], 10)
    teng = SearchEngine.from_state(
        state, config_from_spec(SPEC, fit_sample=1024, lut_dtype=lut_dtype))
    dt, it = teng.search(q[:batch], 10)
    assert teng.last_bucket == jeng.last_bucket
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # the final distances come from the exact f32 re-rank, whose feature
    # sum runs in another order than XLA's
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_bridge_reads_snapshot_key_paths(engines):
    """Snapshots write the state under ['state'] with the reducer params
    unwrapped (['state'].proj[0]); the bridge reads those paths too."""
    _, q, _, arrays, state = engines
    snap = {"['state']" + k.replace(".proj.params", ".proj"): v
            for k, v in arrays.items()}
    s2 = state_from_arrays(snap, SPEC, device="cpu")
    for a, b in zip(s2.proj.params, state.proj.params):
        assert torch.equal(a, b)
    assert torch.equal(s2.corpus, state.corpus)


def test_own_build_reaches_jax_recall(engines):
    """The port's own build_engine (its own generator: fit rows, MPAD start
    directions, k-means starts) against the JAX engine's recall@10."""
    x, q, jeng, _, _ = engines
    jeng.config = dataclasses.replace(jeng.config, lut_dtype="int8")
    _, truth = knn_search(q, x, 10)
    truth = torch.from_numpy(np.asarray(truth)).long()
    _, ij = jeng.search(q, 10)
    r_jax = recall_at_k(torch.from_numpy(np.asarray(ij)).long(), truth)
    teng = build_engine(x, SPEC, device="cpu", mpad=MPADConfig(m=16, iters=8),
                        fit_sample=1024)
    _, it = teng.search(q, 10)
    r_port = recall_at_k(it, truth)
    assert r_port >= r_jax - 0.03, (r_port, r_jax)
    # the port's exact search agrees with JAX's ground truth
    _, tt = knn_scan(torch.from_numpy(q), torch.from_numpy(x), 10)
    assert recall_at_k(tt, truth) == 1.0


def test_build_from_jax_draws_tracks_the_jax_engine(engines):
    """Fed JAX's own random draws (fit-sample rows, MPAD start directions,
    k-means starting rows), the port's build lands on the JAX engine: the
    same projection up to float rounding, and nearly the same answers."""
    x, q, jeng, _, state = engines
    jeng.config = dataclasses.replace(jeng.config, lut_dtype="int8")
    key = jax.random.key(0)                        # ServeConfig.seed
    rows = jax.random.choice(key, N, (1024,), replace=False)
    mkey = jax.random.key(0)                       # MPADConfig.seed
    w0 = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(mkey, k),
                                                (D,))) for k in range(16)])
    k3 = jax.random.fold_in(key, 3)                # the ivfpq build key
    pq_key = jax.random.fold_in(k3, 7)
    pq = np.stack([np.asarray(jax.random.choice(
        jax.random.fold_in(pq_key, m), N, (256,), replace=False))
        for m in range(8)])
    inits = BuildInits(
        fit_rows=torch.from_numpy(np.asarray(rows)).long(),
        w0=torch.from_numpy(w0),
        coarse_init=torch.from_numpy(np.asarray(jax.random.choice(
            k3, N, (32,), replace=False))).long(),
        pq_inits=torch.from_numpy(pq).long())
    teng = build_engine(x, SPEC, device="cpu", mpad=MPADConfig(m=16, iters=8),
                        fit_sample=1024, inits=inits)
    mt, mj = teng.state.proj.params[0], state.proj.params[0]
    cos = (mt * mj).sum(1) / (mt.norm(dim=1) * mj.norm(dim=1))
    assert bool((cos > 0.999).all()), cos
    _, it = teng.search(q, 10)
    _, ij = jeng.search(q, 10)
    overlap = recall_at_k(it, torch.from_numpy(np.asarray(ij)).long())
    assert overlap >= 0.9, overlap


def test_masked_topk_matches_jax():
    from repro.search.knn import masked_topk as jax_masked_topk
    rng = np.random.default_rng(3)
    d2 = rng.integers(0, 9, size=(4, 30)).astype(np.float32)
    d2[:, 5:25] = np.inf
    ids = rng.integers(0, 1000, size=(4, 30))
    for k in (8, 12, 40):                          # 12 > #finite, 40 > C
        dj, ij = jax_masked_topk(d2, ids.astype(np.int32), k)
        dt, it = masked_topk(torch.from_numpy(d2), torch.from_numpy(ids), k)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("s", [
    "flat", "qpad32", "rr128", "ivf64x8", "qpad32>ivf64x8", "pq8x256",
    "pq8x256:f32", "pq8x256:bf16", "pq8x256:i8", "pq8x256:int8",
    "pq8x256@kernel", "pq8x256:i8@kernel", "qpad16>pq4x64:bf16@jnp",
    "ivf64x8>pq8x256", "qpad32>ivf64x8>pq8x256:i8",
    "qpad32>ivf64x8>pq8x256:i8>rr96", "pca32>ivf64x8>pq8x256:i8",
    "mlp16>flat", "flat>rr64", "opq8x256", "qpad32>opq8x256:i8",
])
def test_spec_grammar_agrees_with_jax(s):
    tspec, jspec = parse_spec(s), jax_parse_spec(s)
    assert format_spec(tspec) == jax_format_spec(jspec)
    assert tspec.kind == jspec.kind
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)


def test_unported_kinds_raise_with_a_pointer():
    x = np.zeros((20, 8), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_engine(x, "ivf4x2", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_engine(x, "pca4>ivf4x2", device="cpu")
