"""Port parity: the plain version of kernel K4 (MPAD pairwise threshold
statistics) against repro.kernels.mpad_pairwise's pairwise_stats_ref and,
in interpret mode, pairwise_stats_pallas; its fused entry (the fit's
threshold search and the statistics in one launch) against JAX's
find_quantile_threshold followed by pairwise_stats_pallas; the fit's
``kernel`` backend against the JAX one; and the CUDA kernel's two entries
against their plain versions (on the card only)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels import mpad_pairwise as pw  # noqa: E402

# the |diff| sum runs in another order than XLA's (and, on the card, than
# torch.sum's); count and coeff are exact integers and must be equal
SUM_RTOL = 1e-6


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu test alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import mpad_pairwise as jpw
    return jax, jax.numpy, jpw


def _p(n, seed, repeated=False):
    rng = np.random.default_rng(seed)
    if repeated:                                   # many exact repeats
        return rng.integers(0, 12, n).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


def _assert_stats(got, want):
    (ct, st, ft), (cj, sj, fj) = got, want
    assert int(ct) == int(cj)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_allclose(float(st), float(sj), rtol=SUM_RTOL)


@pytest.mark.parametrize("n", [1, 2, 97, 300])
@pytest.mark.parametrize("repeated", [False, True])
@pytest.mark.parametrize("tau", [0.0, 0.5, float("inf")])
def test_plain_matches_jax_ref(n, repeated, tau):
    _, jnp, jpw = _jax()
    p = _p(n, n, repeated)
    want = jpw.pairwise_stats_ref(jnp.asarray(p), jnp.float32(tau))
    got = pw.pairwise_stats(torch.from_numpy(p), tau)
    _assert_stats(got, want)


@pytest.mark.parametrize("n,block", [(64, 64), (200, 64), (257, 128)])
def test_plain_matches_interpret_mode_pallas(n, block):
    _, jnp, jpw = _jax()
    p = _p(n, 7)
    want = jpw.pairwise_stats_pallas(jnp.asarray(p), jnp.float32(0.4),
                                     block_i=block, block_j=block,
                                     interpret=True)
    got = pw.pairwise_stats_ref(torch.from_numpy(p), 0.4)
    _assert_stats(got, want)


def test_wrapper_takes_a_device_tau_and_rejects_bad_inputs():
    p = torch.from_numpy(_p(50, 3))
    a = pw.pairwise_stats(p, torch.tensor(0.7))
    b = pw.pairwise_stats_ref(p, 0.7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match=r"\(N,\)"):
        pw.pairwise_stats(p[None], 0.7)
    with pytest.raises(ValueError, match="scalar"):
        pw.pairwise_stats(p, torch.ones(2))


def _k_pairs(n, which):
    return {"one": 1, "b80": max(1, int(n * (n - 1) // 2 * 0.8)),
            "all": n * (n - 1) // 2}[which]


@pytest.mark.parametrize("n", [1, 2, 97, 300])
@pytest.mark.parametrize("repeated", [False, True])
@pytest.mark.parametrize("which", ["one", "b80", "all"])
def test_fused_plain_matches_jax_threshold_and_pallas(n, repeated, which):
    """The fused entry on the CPU (its plain version) against JAX's
    find_quantile_threshold and, at that tau, pairwise_stats_pallas in
    interpret mode: tau bit-equal, count and coeff equal, the sum within
    the file's tolerance."""
    _, jnp, jpw = _jax()
    from repro.core.fast_objective import find_quantile_threshold
    p = _p(n, n + 1, repeated)
    k = _k_pairs(n, which)
    tj = find_quantile_threshold(jnp.asarray(p), k)
    want = jpw.pairwise_stats_pallas(jnp.asarray(p), tj, block_i=128,
                                     block_j=128, interpret=True)
    tau, *got = pw.pairwise_stats_at_quantile(torch.from_numpy(p), k)
    np.testing.assert_array_equal(tau.numpy().view(np.uint32),
                                  np.asarray(tj).view(np.uint32))
    _assert_stats(got, want)


def test_fused_wrapper_on_cpu_and_bad_inputs():
    """The CPU route is the plain version (the fit's bisection, then the
    statistics at it); a 2-D or empty p raises."""
    p = torch.from_numpy(_p(120, 4))
    got = pw.pairwise_stats_at_quantile(p, 3000)
    want = pw.pairwise_stats_at_quantile_ref(p, 3000)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    from repro_torch.core.fast_objective import find_quantile_threshold
    assert torch.equal(got[0], find_quantile_threshold(p, 3000))
    with pytest.raises(ValueError, match=r"\(N,\)"):
        pw.pairwise_stats_at_quantile(p[None], 10)
    with pytest.raises(ValueError, match="at least one"):
        pw.pairwise_stats_at_quantile(p[:0], 10)


def _objective_inputs(seed, n=400, d=24):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * np.linspace(3.0, 0.3, d)).astype(
        np.float32)
    w = rng.normal(size=d).astype(np.float32)
    w /= np.linalg.norm(w)
    prev = rng.normal(size=(4, d)).astype(np.float32)
    prev /= np.linalg.norm(prev, axis=1, keepdims=True)
    return x, w, prev, np.array([1, 1, 0, 0], np.float32)


@pytest.mark.parametrize("seed,b,alpha", [(0, 80.0, 25.0), (1, 30.0, 5.0)])
def test_kernel_phi_matches_jax(seed, b, alpha):
    """phi value and tangent gradient of the kernel backend against JAX's
    phi_kernel_value_and_grad (its Pallas kernel in interpret mode)."""
    _, jnp, jpw = _jax()
    x, w, prev, mask = _objective_inputs(seed)
    vj, gj = jpw.phi_kernel_value_and_grad(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(prev), jnp.asarray(mask),
        b=b, alpha=alpha, interpret=True, block=128)
    vt, gt = pw.phi_kernel_value_and_grad(
        torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(prev),
        torch.from_numpy(mask), b=b, alpha=alpha)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    # x.T @ coeff sums in another order than XLA's
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)


def test_short_kernel_fit_from_jax_start_directions():
    """m=3, iters=6 on the kernel backend from JAX's start directions: every
    fitted row within cosine 0.999 of the JAX kernel-backend fit's."""
    jax, jnp, _ = _jax()
    from repro.core import MPADConfig as JConfig
    from repro.core import fit_mpad as jax_fit_mpad
    from repro_torch.core import MPADConfig, fit_mpad
    x, _, _, _ = _objective_inputs(5, n=300, d=16)
    cfg = dict(m=3, iters=6, b=80.0, alpha=25.0, seed=7, backend="kernel")
    jres = jax_fit_mpad(jnp.asarray(x), JConfig(**cfg))
    key = jax.random.key(cfg["seed"])
    w0 = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, k),
                                                (x.shape[1],), jnp.float32))
                   for k in range(cfg["m"])])
    before = pw.pairwise_stats.launches
    tres = fit_mpad(torch.from_numpy(x), MPADConfig(**cfg),
                    w0=torch.from_numpy(w0), device="cpu")
    assert pw.pairwise_stats.launches == before     # CPU: the plain version
    mj, mt = np.asarray(jres.matrix), tres.matrix.numpy()
    cos = (mj * mt).sum(1) / (np.linalg.norm(mj, axis=1)
                              * np.linalg.norm(mt, axis=1))
    assert (cos > 0.999).all(), cos
    # Adam carries each step's last-bit differences into the next, so the
    # phi trace drifts a little further than one evaluation does
    np.testing.assert_allclose(tres.objective_trace.numpy(),
                               np.asarray(jres.objective_trace), rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("n,repeated", [(1, False), (2048, False),
                                        (2500, True), (20_000, False)])
def test_cuda_kernel_matches_plain_version(n, repeated):
    """K4 on the card against its plain version on the same CUDA inputs:
    count and coeff equal, sum within 1e-5 relative (another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    p = torch.from_numpy(_p(n, 9, repeated)).cuda()
    for tau in (0.0, 0.5, float("inf")):
        before = pw.pairwise_stats.launches
        ck, sk, fk = pw.pairwise_stats(p, torch.tensor(tau, device="cuda"))
        torch.cuda.synchronize()
        assert pw.pairwise_stats.launches == before + 1
        cp, sp, fp = pw.pairwise_stats_ref(p, tau)
        assert int(ck) == int(cp)
        assert torch.equal(fk, fp)
        torch.testing.assert_close(sk, sp, rtol=1e-5, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,repeated", [(1, False), (2, False), (1000, True),
                                        (2048, False), (20_000, False)])
@pytest.mark.parametrize("which", ["one", "b80", "all"])
def test_cuda_fused_kernel_matches_plain_version(n, repeated, which):
    """K4's fused entry on the card (N 20,000 takes its global-scratch
    route) against its plain version on the same CUDA inputs: tau
    bit-equal, count and coeff equal, sum within 1e-5 relative, one launch,
    and a second call bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    p = torch.from_numpy(_p(n, 10, repeated)).cuda()
    k = _k_pairs(n, which)
    before = pw.pairwise_stats_at_quantile.launches
    tau, ck, sk, fk = pw.pairwise_stats_at_quantile(p, k)
    torch.cuda.synchronize()
    assert pw.pairwise_stats_at_quantile.launches == before + 1
    tp, cp, sp, fp = pw.pairwise_stats_at_quantile_ref(p, k)
    assert torch.equal(tau.view(torch.int32), tp.view(torch.int32))
    assert int(ck) == int(cp)
    assert torch.equal(fk, fp)
    torch.testing.assert_close(sk, sp, rtol=1e-5, atol=0.0)
    again = pw.pairwise_stats_at_quantile(p, k)
    assert all(torch.equal(a, b) for a, b in zip(again, (tau, ck, sk, fk)))
