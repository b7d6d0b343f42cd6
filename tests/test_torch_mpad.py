"""Port parity: the fast MPAD objective and the greedy fit
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
from repro_torch.core import MPADConfig, fit_mpad  # noqa: E402
from repro_torch.core import fast_objective as tfo  # noqa: E402
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
    x = torch.from_numpy(_data(5, n=50, d=8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit_mpad(x, MPADConfig(m=2, iters=1, backend="exact"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit_mpad(x, MPADConfig(m=2, iters=1))
