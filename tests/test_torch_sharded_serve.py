"""Sharded serving of the port over gloo ranks on the CPU (twin of
tests/test_sharded_serve.py): ``sharded_search_fn`` over ``shard_engine``
must return JAX's single-device ``search_fn`` ids (distances within atol
1e-5) for every kind, f32 and int8 tables, the plain and the kernel
backend (here the kernels' plain versions), at 1, 2 and 8 ranks; at one
rank also JAX's ``sharded_search_fn`` on a one-device mesh. N 601 and 12
cells divide by none of the rank counts, so pad rows, pad cells and K2's
over-fetch slack are live. Then the engine: ``SearchEngine.shard`` with
the context's mesh, bucket padding, the refused fast paths, donation and
the metrics label.

The JAX states are built once in this process and carried to the ranks
as numpy arrays (``bridge.state_from_arrays``); the ranks are spawned
once a world size for the whole module and import no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

N, DIM, K = 601, 32, 10
WORLDS = (1, 2, 8)
SPECS = {"flat": "qpad8>rr64", "ivf": "qpad8>ivf12x5>rr64",
         "pq": "qpad8>pq8x64>rr64", "opq": "qpad8>opq8x64>rr64",
         "ivfpq": "qpad8>ivf12x5>pq8x64>rr64"}
CASES = ([("flat", "f32", "jnp"), ("ivf", "f32", "jnp")]
         + [(kind, lut, backend) for kind in ("pq", "opq", "ivfpq")
            for lut in ("f32", "int8") for backend in ("jnp", "kernel")])
KW = dict(nprobe=5, rerank=64)
ONE_RANK = (("ivfpq", "int8"),)      # cases also held against JAX's
#                                      sharded_search_fn on one device


def _data(seed=0, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2
    lab = rng.integers(0, 12, n)
    return (centers[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _queries(nq=24):
    rng = np.random.default_rng(9)
    return (_data()[:nq] + 0.02 * rng.normal(size=(nq, DIM))).astype(
        np.float32)


def rank_cases(mesh, arrays, q):
    """One rank: every case of ``CASES`` through ``shard_engine`` and
    ``sharded_search_fn``, then the engine-level checks on ivfpq. Returns
    host data (rank 0's is the module's result)."""
    from repro_torch.bridge import state_from_arrays
    from repro_torch.parallel import all_gather, mesh_context, shard_engine
    from repro_torch.search import (SearchEngine, config_from_spec,
                                    sharded_search_fn)
    qt = torch.from_numpy(q)
    states = {kind: state_from_arrays(arrays[kind], spec, device="cpu")
              for kind, spec in SPECS.items()}
    out = {}
    for kind, lut, backend in CASES:
        sstate = shard_engine(states[kind], mesh)
        d, i = sharded_search_fn(sstate, qt, K, mesh=mesh, backend=backend,
                                 lut_dtype=lut, **KW)
        every = all_gather(mesh, i[None], dim=0)
        out[(kind, lut, backend)] = (d.numpy(), i.numpy(),
                                     bool((every == i).all()))
    # the engine: the context's mesh, buckets, refusals, donation
    spec = "qpad8>ivf12x5>pq8x64:i8@kernel>rr64"
    eng = SearchEngine.from_state(states["ivfpq"], config_from_spec(spec))
    d0, i0 = eng.search(qt, K)
    with mesh_context(mesh):
        eng.shard()
    d1, i1 = eng.search(qt, K)
    d5, i5 = eng.search(qt[:5], K)            # the small-batch bucket
    refused = []
    for knob in ("scan_cap", "prefilter"):
        try:
            sharded_search_fn(eng.sharded_state, qt, K, mesh=mesh,
                              **{knob: 32})
        except ValueError as exc:
            refused.append(str(exc))
    out["engine"] = dict(
        i0=i0.numpy(), d0=d0.numpy(), i1=i1.numpy(), d1=d1.numpy(),
        i5=i5.numpy(), d5=d5.numpy(), compile_count=eng.compile_count,
        sharded=eng.metrics().engine.sharded, refused=refused,
        rows=int(eng.sharded_state.corpus.shape[0]))
    fresh = state_from_arrays(arrays["ivfpq"], SPECS["ivfpq"], device="cpu")
    eng2 = SearchEngine.from_state(fresh, config_from_spec(spec))
    eng2.shard(mesh, donate=True)
    d2, i2 = eng2.search(qt, K)
    out["donated"] = dict(i=i2.numpy(), d=d2.numpy(),
                          state_gone=eng2.state is None,
                          freed=fresh.index.payload.codes.numel() == 0
                          or mesh.size == 1)
    return out


def _state_arrays(state):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.fixture(scope="module")
def runs():
    """JAX engines, JAX's single-device (and one-device sharded) ids, and
    the ranks' results at each world size."""
    import jax
    from repro.core import MPADConfig
    from repro.search import build_engine, search_fn
    from repro.search import sharded_search_fn as jax_sharded
    from repro.parallel.engine import shard_engine as jax_shard_engine
    from repro_torch.launch.mesh import run_ranks
    q = _queries()
    jengs = {kind: build_engine(_data(), spec, fit_sample=512,
                                mpad=MPADConfig(m=8, iters=16))
             for kind, spec in SPECS.items()}
    mesh = jax.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    want, want_1 = {}, {}
    for kind, lut, backend in CASES:
        if backend == "jnp":
            state = jengs[kind].state
            want[(kind, lut)] = tuple(np.asarray(a) for a in search_fn(
                state, q, K, backend="jnp", lut_dtype=lut, **KW))
            if (kind, lut) in ONE_RANK:      # a shard_map trace is ~15 s
                want_1[(kind, lut)] = np.asarray(jax_sharded(
                    jax_shard_engine(state, mesh), q, K, mesh=mesh,
                    backend="jnp", lut_dtype=lut, **KW)[1])
    arrays = {kind: _state_arrays(e.state) for kind, e in jengs.items()}
    got = {w: run_ranks(rank_cases, w, (arrays, q), device="cpu")
           for w in WORLDS}
    return want, want_1, got


@pytest.mark.parametrize("case", CASES, ids="-".join)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax_single_device(runs, world, case):
    want, _, got = runs
    d, i, replicated = got[world][case]
    dj, ij = want[case[:2]]
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_allclose(d, dj, atol=1e-5)
    assert replicated, "the ranks returned different ids"


@pytest.mark.parametrize("backend", ["jnp", "kernel"])
@pytest.mark.parametrize("case", ONE_RANK, ids="-".join)
def test_one_rank_matches_jax_sharded_search_fn(runs, case, backend):
    _, want_1, got = runs
    np.testing.assert_array_equal(got[1][case + (backend,)][1],
                                  want_1[case])


@pytest.mark.parametrize("world", WORLDS)
def test_engine_shard_with_context_mesh(runs, world):
    """``shard()`` takes the context's mesh and changes nothing served;
    the sharded program is keyed apart; metrics say sharded."""
    e = runs[2][world]["engine"]
    np.testing.assert_array_equal(e["i1"], e["i0"])
    np.testing.assert_allclose(e["d1"], e["d0"], atol=1e-5)
    assert e["compile_count"] >= 2 and e["sharded"]
    assert e["rows"] == -(-N // world)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_bucket_padding_never_perturbs_results(runs, world):
    e = runs[2][world]["engine"]
    np.testing.assert_array_equal(e["i5"], e["i1"][:5])
    np.testing.assert_allclose(e["d5"], e["d1"][:5], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_path_refuses_single_device_fast_paths(runs, world):
    refused = runs[2][world]["engine"]["refused"]
    assert len(refused) == 2
    assert all("scan_cap/prefilter" in r for r in refused)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_donate_serves_the_same_ids(runs, world):
    e, dn = runs[2][world]["engine"], runs[2][world]["donated"]
    np.testing.assert_array_equal(dn["i"], e["i0"])
    np.testing.assert_allclose(dn["d"], e["d0"], atol=1e-5)
    assert dn["state_gone"] and dn["freed"]
