"""Port parity: the fast and exact MPAD objectives and the greedy fit
(repro_torch.core) against repro.core on the same numpy inputs; the fit
starts from JAX's own start directions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import MPADConfig as JConfig  # noqa: E402
from repro.core import fast_objective as jfo  # noqa: E402
from repro.core import fit_mpad as jax_fit_mpad  # noqa: E402
from repro.core import mpad as jmpad  # noqa: E402
from repro.core import objective as jobj  # noqa: E402
from repro_torch.core import MPADConfig, fit_mpad  # noqa: E402
from repro_torch.core import fast_objective as tfo  # noqa: E402
from repro_torch.core import mpad as tmpad  # noqa: E402
from repro_torch.core import objective as tobj  # noqa: E402
from repro_torch.core.objective import (num_selected_pairs,  # noqa: E402
                                        orthogonality_penalty)


def _data(seed, n=400, d=24):
    rng = np.random.default_rng(seed)
    scales = np.linspace(3.0, 0.3, d)
    return (rng.normal(size=(n, d)) * scales).astype(np.float32)


@pytest.mark.parametrize("seed,b,alpha", [(0, 80.0, 25.0), (1, 30.0, 5.0),
                                          (2, 100.0, 0.0)])
def test_phi_value_and_grad_match_jax(seed, b, alpha):
    x = _data(seed)
    rng = np.random.default_rng(seed + 10)
    w = rng.normal(size=x.shape[1]).astype(np.float32)
    w /= np.linalg.norm(w)
    prev = rng.normal(size=(4, x.shape[1])).astype(np.float32)
    prev /= np.linalg.norm(prev, axis=1, keepdims=True)
    mask = np.array([1, 1, 0, 0], np.float32)
    vj, gj = jfo.phi_fast_value_and_grad(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(prev), jnp.asarray(mask),
        b=b, alpha=alpha)
    vt, gt = tfo.phi_fast_value_and_grad(
        torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(prev),
        torch.from_numpy(mask), b=b, alpha=alpha)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)


def test_threshold_and_stats_match_jax():
    x = _data(3)
    p = (x @ np.linspace(1.0, -1.0, x.shape[1]).astype(np.float32))
    k_pairs = num_selected_pairs(p.shape[0], 40.0)
    tj = jfo.find_quantile_threshold(jnp.asarray(p), k_pairs)
    tt = tfo.find_quantile_threshold(torch.from_numpy(p), k_pairs)
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-6)
    sj = jfo.threshold_stats(jnp.asarray(p), tj)
    st = tfo.threshold_stats(torch.from_numpy(p), torch.tensor(float(tj)))
    assert int(st.count) == int(sj.count)
    np.testing.assert_array_equal(st.coeff.numpy(), np.asarray(sj.coeff))
    np.testing.assert_allclose(float(st.sum), float(sj.sum), rtol=1e-5)


def test_orthogonality_penalty():
    w = torch.tensor([1.0, 0.0])
    prev = torch.tensor([[0.6, 0.8], [0.0, 1.0]])
    assert float(orthogonality_penalty(w, prev, 2.0)) == pytest.approx(0.72)
    assert float(orthogonality_penalty(w, prev[:0], 2.0)) == 0.0


def test_short_fit_from_jax_start_directions():
    """m=4, iters=8 from JAX's start directions: every fitted row within
    cosine 0.999 of JAX's."""
    x = _data(4, n=500, d=32)
    cfg = dict(m=4, iters=8, b=80.0, alpha=25.0, seed=7)
    jres = jax_fit_mpad(jnp.asarray(x), JConfig(**cfg))
    key = jax.random.key(cfg["seed"])
    w0 = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, k),
                                                (x.shape[1],), jnp.float32))
                   for k in range(cfg["m"])])
    tres = fit_mpad(torch.from_numpy(x), MPADConfig(**cfg),
                    w0=torch.from_numpy(w0), device="cpu")
    mj = np.asarray(jres.matrix)
    mt = tres.matrix.numpy()
    cos = (mj * mt).sum(1) / (np.linalg.norm(mj, axis=1)
                              * np.linalg.norm(mt, axis=1))
    assert (cos > 0.999).all(), cos
    np.testing.assert_allclose(tres.mean.numpy(), np.asarray(jres.mean),
                               rtol=1e-5, atol=1e-6)
    assert tres.objective_trace.shape == (4, 8)


def test_unported_backends_raise_and_device_is_required():
    """Every fit backend is ported (exact, fast, kernel), and so is every
    index kind downstream of a fit: an engine of the ivf kind fits its
    reducer, builds the index and serves. Without a device argument and
    with no CUDA device, the fit raises."""
    from repro_torch.search import build_engine
    x = torch.from_numpy(_data(5, n=50, d=8))
    eng = build_engine(x, "qpad2>ivf4x2>rr8", device="cpu",
                       mpad=MPADConfig(m=2, iters=1))
    assert eng.state.index.kind == "ivf"
    assert eng.state.index.payload.vectors.shape == (50, 2)
    _, ids = eng.search(x[:4], 3)
    assert ids.shape == (4, 3) and bool((ids >= 0).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit_mpad(x, MPADConfig(m=2, iters=1))


def _wx(seed, n=200, d=16):
    x = _data(seed, n=n, d=d)
    w = np.random.default_rng(seed + 1).normal(size=d).astype(np.float32)
    return x, w / np.linalg.norm(w)


def test_pairwise_abs_diff_matches_jax():
    p = np.random.default_rng(0).normal(size=37).astype(np.float32)
    np.testing.assert_array_equal(
        tobj.pairwise_abs_diff(torch.from_numpy(p)).numpy(),
        np.asarray(jobj.pairwise_abs_diff(jnp.asarray(p))))


@pytest.mark.parametrize("b", [5.0, 25.0, 50.0, 80.0, 100.0])
def test_mu_b_exact_value_and_grad_match_jax(b):
    """The value is the mean of the same selected |p_i - p_j| (rtol 1e-5:
    the projections come from matmuls summed in another order); the
    gradient flows to the same pairs, since the selection keeps JAX's tie
    order (atol 1e-5 of a gradient of ~1)."""
    x, w = _wx(0)
    vj, gj = jobj.mu_b_exact_value_and_grad(jnp.asarray(w), jnp.asarray(x),
                                            b=b)
    vt, gt = tobj.mu_b_exact_value_and_grad(torch.from_numpy(w),
                                            torch.from_numpy(x), b=b)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)
    assert float(tobj.mu_b_exact(torch.from_numpy(w), torch.from_numpy(x),
                                 b=b)) == pytest.approx(float(vt))


def test_phi_exact_matches_jax():
    x, w = _wx(1)
    prev = np.random.default_rng(9).normal(size=(3, 16)).astype(np.float32)
    vj = jobj.phi_exact(jnp.asarray(w), jnp.asarray(x), jnp.asarray(prev),
                        b=70.0, alpha=3.0)
    vt = tobj.phi_exact(torch.from_numpy(w), torch.from_numpy(x),
                        torch.from_numpy(prev), b=70.0, alpha=3.0)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)


@pytest.mark.parametrize("seed,b,alpha", [(0, 80.0, 25.0), (1, 30.0, 5.0)])
def test_exact_backend_phi_and_grad_match_jax(seed, b, alpha):
    """The exact backend normalizes w inside mu_b and in the masked
    penalty, so its gradient is tangent to the sphere; value within rtol
    1e-5 and gradient within atol 1e-4 of JAX's (the tolerance of the fast
    backend's parity test above)."""
    x = _data(seed, n=300, d=24)
    rng = np.random.default_rng(seed + 10)
    w = rng.normal(size=24).astype(np.float32) * 1.7      # not unit norm
    prev = rng.normal(size=(4, 24)).astype(np.float32)
    prev /= np.linalg.norm(prev, axis=1, keepdims=True)
    mask = np.array([1, 1, 0, 0], np.float32)
    vj, gj = jmpad._phi_exact_value_and_grad(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(prev), jnp.asarray(mask),
        b=b, alpha=alpha)
    vt, gt = tmpad._phi_exact_value_and_grad(
        torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(prev),
        torch.from_numpy(mask), b=b, alpha=alpha)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)
    assert abs(float(gt @ torch.from_numpy(w))) < 1e-4     # tangent


def test_exact_and_fast_backends_agree():
    """The exact oracle against the port's fast path at one w: the
    tolerance of tests/test_objective.py (value rtol 1e-5, gradient atol
    5e-3: f32 rounding may swap a boundary pair in or out of D_b)."""
    x, w = _wx(2)
    prev = torch.zeros((2, 16))
    mask = torch.zeros(2)
    ve, ge = tmpad._phi_exact_value_and_grad(
        torch.from_numpy(w), torch.from_numpy(x), prev, mask, b=60.0,
        alpha=25.0)
    vf, gf = tfo.phi_fast_value_and_grad(
        torch.from_numpy(w), torch.from_numpy(x), prev, mask, b=60.0,
        alpha=25.0)
    np.testing.assert_allclose(float(ve), float(vf), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ge.numpy(), gf.numpy(), atol=5e-3)


def test_short_exact_fit_from_jax_start_directions():
    """backend="exact", m=3, iters=6 from JAX's start directions: every
    fitted row within cosine 0.999 of JAX's."""
    x = _data(6, n=150, d=12)
    cfg = dict(m=3, iters=6, b=80.0, alpha=25.0, seed=3, backend="exact")
    jres = jax_fit_mpad(jnp.asarray(x), JConfig(**cfg))
    key = jax.random.key(cfg["seed"])
    w0 = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, k),
                                                (x.shape[1],), jnp.float32))
                   for k in range(cfg["m"])])
    tres = fit_mpad(torch.from_numpy(x), MPADConfig(**cfg),
                    w0=torch.from_numpy(w0), device="cpu")
    mj, mt = np.asarray(jres.matrix), tres.matrix.numpy()
    cos = (mj * mt).sum(1) / (np.linalg.norm(mj, axis=1)
                              * np.linalg.norm(mt, axis=1))
    assert (cos > 0.999).all(), cos
    # phi per step (values of ~1): the packages' Adam steps differ by the
    # gradients' f32 rounding, which moves phi by ~1e-5
    np.testing.assert_allclose(tres.objective_trace.numpy(),
                               np.asarray(jres.objective_trace), rtol=1e-4,
                               atol=1e-4)
