"""Distributed MPAD of the port over gloo ranks on the CPU (twin of
tests/test_distributed.py): the distributed phi value (rtol 1e-5) and
gradient (rtol 1e-3, atol 1e-5) against JAX's
``phi_fast_value_and_grad``, and ``fit_mpad_sharded``'s matrix within
0.05 of JAX's ``fit_mpad`` (on JAX's own test's rows) and of the port's
``fit_mpad`` from the same start directions, at 2 and 8 ranks; rows that
do not divide the ranks are refused. JAX runs in this
process only; the ranks are spawned once a world size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLDS = (2, 8)
N, D, M = 256, 24, 3


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32)
    prev = np.zeros((M, D), np.float32)
    prev[0] = rng.normal(size=D)
    prev[0] /= np.linalg.norm(prev[0])
    mask = np.array([1.0, 0.0, 0.0], np.float32)
    return x, w / np.linalg.norm(w), prev, mask


def rank_fit(mesh, x_fit, w0):
    """One rank: phi_dist without and with the penalty, the sharded fit,
    and the refusal of rows that do not divide the ranks."""
    from repro_torch.core import MPADConfig
    from repro_torch.core.distributed import fit_mpad_sharded, make_phi_dist
    x, w, prev, mask = (torch.from_numpy(a) for a in _inputs())
    xc = x - x.mean(dim=0)
    per = N // mesh.size
    phi = make_phi_dist(mesh, N)
    x_loc = xc[mesh.rank * per:(mesh.rank + 1) * per]
    out = {}
    for name, (p, m) in {"plain": (torch.zeros_like(prev),
                                   torch.zeros_like(mask)),
                         "penalized": (prev, mask)}.items():
        v, g = phi(w, x_loc, p, m, b=80.0, alpha=25.0)
        out[name] = (float(v), g.numpy())
    res = fit_mpad_sharded(torch.from_numpy(x_fit), MPADConfig(m=M, iters=16),
                           mesh, w0=torch.from_numpy(w0))
    out["fit"] = res.matrix.numpy()
    try:
        fit_mpad_sharded(x[:N - 1], MPADConfig(m=M, iters=2), mesh,
                         w0=torch.from_numpy(w0))
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    return out


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp
    from repro.core.fast_objective import phi_fast_value_and_grad
    from repro.core.mpad import MPADConfig, fit_mpad
    from repro_torch.launch.mesh import run_ranks
    x, w, prev, mask = _inputs()
    xc = x - x.mean(axis=0)
    want = {}
    for name, (p, m) in {"plain": (np.zeros_like(prev), np.zeros_like(mask)),
                         "penalized": (prev, mask)}.items():
        v, g = phi_fast_value_and_grad(jnp.asarray(w), jnp.asarray(xc),
                                       jnp.asarray(p), jnp.asarray(m),
                                       b=80.0, alpha=25.0)
        want[name] = (float(v), np.asarray(g))
    cfg = MPADConfig(m=M, iters=16)
    key = jax.random.key(cfg.seed)
    # JAX's fit draws direction k from fold_in(key, k)
    w0 = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, k),
                                                (D,), jnp.float32))
                   for k in range(M)])
    # the rows of JAX's own distributed test
    x_fit = np.asarray(jax.random.normal(jax.random.key(0), (N, D)))
    want["fit"] = np.asarray(fit_mpad(jnp.asarray(x_fit), cfg).matrix)
    from repro_torch.core import MPADConfig as TorchConfig
    from repro_torch.core import fit_mpad as torch_fit
    want["port_fit"] = torch_fit(torch.from_numpy(x_fit),
                                 TorchConfig(m=M, iters=16),
                                 w0=torch.from_numpy(w0),
                                 device="cpu").matrix.numpy()
    got = {wd: run_ranks(rank_fit, wd, (x_fit, w0), device="cpu")
           for wd in WORLDS}
    return want, got


@pytest.mark.parametrize("name", ["plain", "penalized"])
@pytest.mark.parametrize("world", WORLDS)
def test_phi_dist_matches_jax_phi_fast(runs, world, name):
    want, got = runs
    vt, gt = got[world][name]
    vj, gj = want[name]
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("ref", ["fit", "port_fit"])
@pytest.mark.parametrize("world", WORLDS)
def test_fit_mpad_sharded_matches_jax_fit(runs, world, ref):
    want, got = runs
    err = float(np.abs(got[world]["fit"] - want[ref]).max())
    assert err < 0.05, err


@pytest.mark.parametrize("world", WORLDS)
def test_fit_mpad_sharded_refuses_rows_off_the_ranks(runs, world):
    assert runs[1][world]["refused"]
