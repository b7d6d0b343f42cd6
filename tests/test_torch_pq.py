"""Port parity: the plain-PQ and OPQ scans and builds
(repro_torch.search.pq, the pq and opq kinds of repro_torch.search.registry)
against repro.search on the same numpy inputs. The scans run on indexes the
JAX package built; the OPQ build is fed JAX's own k-means starting rows."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.search import pq as jpq  # noqa: E402
from repro.search import registry as jreg  # noqa: E402
from repro.search.spec import parse_spec as jax_parse_spec  # noqa: E402
from repro_torch.search import pq as tpq  # noqa: E402
from repro_torch.search import registry as treg  # noqa: E402
from repro_torch.search.spec import parse_spec  # noqa: E402

N, D, M, K, NQ, NCAND = 1500, 16, 4, 64, 64, 20
SPEC = f"opq{M}x{K}"


def _corpus(seed, n, d=D, n_clusters=12):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 4.0
    lab = rng.integers(0, n_clusters, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pq_inits(key, n):
    """The starting rows JAX draws for subspace m's codebook:
    choice(fold_in(fold_in(key, 2), m), n, (K,)), as _pq_build and every
    iterate of _opq_build use them."""
    pq_key = jax.random.fold_in(key, 2)
    return torch.from_numpy(np.stack([np.asarray(jax.random.choice(
        jax.random.fold_in(pq_key, m), n, (min(K, n),), replace=False))
        for m in range(M)])).long()


@pytest.fixture(scope="module")
def built():
    x = _corpus(0, N)
    q = _corpus(1, NQ)
    key = jax.random.key(3)
    spec = jax_parse_spec(SPEC)
    jpq_ix = jreg.get_ops("pq").build(key, jnp.asarray(x), spec)
    jopq_ix = jreg.get_ops("opq").build(key, jnp.asarray(x), spec)
    tpq_ix = tpq.PQIndex(*(_t(a) for a in jpq_ix))
    topq_ix = treg.OPQIndex(*(_t(a) for a in jopq_ix))
    return x, q, key, jpq_ix, jopq_ix, tpq_ix, topq_ix


@pytest.mark.parametrize("backend", ["jnp", "kernel"])
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_pq_scan_returns_jax_ids(built, backend, lut_dtype):
    _, q, _, jix, _, tix, _ = built
    dj, ij = jpq.pq_scan(jix, jnp.asarray(q), NCAND, lut_dtype=lut_dtype)
    dt, it = tpq.pq_scan(tix, torch.from_numpy(q), NCAND, backend=backend,
                         lut_dtype=lut_dtype)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # ||q||^2 and the row means are summed in another order than XLA's
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


@pytest.mark.parametrize("backend", ["jnp", "kernel"])
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_opq_scan_returns_jax_ids(built, backend, lut_dtype):
    """The opq kind's scan (rotate, then the pq scan) on the JAX-built
    rotation and codes."""
    _, q, _, _, jix, _, tix = built
    jstate = types.SimpleNamespace(index=jreg.Index("opq", jix))
    tstate = types.SimpleNamespace(index=treg.Index("opq", tix))
    dj, ij = jreg.get_ops("opq").scan(
        jstate, jnp.asarray(q), NCAND, jreg.ScanParams(lut_dtype=lut_dtype))
    dt, it = treg.get_ops("opq").scan(
        tstate, torch.from_numpy(q), NCAND,
        treg.ScanParams(backend=backend, lut_dtype=lut_dtype))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_pq_scan_pads_k_above_n(built):
    """Both backends return (+inf, -1) past the row count."""
    _, q, _, _, _, tix, _ = built
    small = tix._replace(codes=tix.codes[:15])
    for backend in ("jnp", "kernel"):
        d, i = tpq.pq_scan(small, torch.from_numpy(q[:3]), NCAND,
                           backend=backend, lut_dtype="int8")
        assert bool(torch.isinf(d[:, 15:]).all())
        assert bool((i[:, 15:] == -1).all()) and bool((i[:, :15] >= 0).all())


def test_pq_build_and_reconstruct_match_jax(built):
    """_pq_build from JAX's starting rows: codebooks allclose, codes equal
    up to distance ties; pq_reconstruct decodes as the JAX one does."""
    x, _, key, jix, _, tix, _ = built
    inits = treg.BuildInits(pq_inits=_pq_inits(key, N))
    own = treg.get_ops("pq").build(torch.from_numpy(x), parse_spec(SPEC),
                                   None, inits)
    # the one-hot matmul and index_add_ sum the clusters in other orders
    np.testing.assert_allclose(own.codebooks.numpy(),
                               np.asarray(jix.codebooks), rtol=1e-4,
                               atol=1e-5)
    assert (own.codes.numpy() == np.asarray(jix.codes)).mean() > 0.999
    np.testing.assert_array_equal(tpq.pq_reconstruct(tix).numpy(),
                                  np.asarray(jpq.pq_reconstruct(jix)))


def test_opq_build_from_jax_draws(built):
    """_opq_build from JAX's starting rows: the same rotation (allclose)
    and codes equal up to distance ties."""
    x, _, key, _, jix, _, _ = built
    inits = treg.BuildInits(pq_inits=_pq_inits(key, N))
    own = treg.get_ops("opq").build(torch.from_numpy(x), parse_spec(SPEC),
                                    None, inits)
    rot_j = np.asarray(jix.rot)
    assert not np.allclose(rot_j, np.eye(D))      # a rotation was learned
    np.testing.assert_allclose(own.rot.numpy(), rot_j, atol=1e-5)
    np.testing.assert_allclose(own.rot.numpy() @ own.rot.numpy().T,
                               np.eye(D), atol=1e-5)
    assert (own.codes.numpy() == np.asarray(jix.codes)).mean() > 0.999
