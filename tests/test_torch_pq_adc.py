"""Port parity: the plain version of kernel K1 (fused ADC-gather top-k)
against repro.kernels.pq_adc.ref.pq_adc_gather_topk_ref, the lax.top_k
tie order of topk_smallest, and the CUDA kernel against its plain version
(on the card only)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels.pq_adc import ops  # noqa: E402
from repro_torch.kernels.pq_adc.ref import pq_adc_gather_topk_ref  # noqa: E402
from repro_torch.search.knn import topk_smallest  # noqa: E402

# f32/bf16: the M-term sum runs in another order than XLA's
RTOL = {"f32": 1e-6, "bf16": 1e-6}


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu test alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.pq_adc.ref import pq_adc_gather_topk_ref
    return jax, jax.numpy, pq_adc_gather_topk_ref


def _inputs(seed, nq, c, m, kc, n_masked=0, scale=5.0):
    rng = np.random.default_rng(seed)
    tables = (rng.uniform(size=(nq, m, kc)) * scale).astype(np.float32)
    codes = rng.integers(0, kc, size=(nq, c, m)).astype(np.uint8)
    base = rng.uniform(size=(nq, c)).astype(np.float32)
    if n_masked:
        base[:, -n_masked:] = np.inf
        base[::2, :n_masked] = np.inf        # masked slots at both ends
    return tables, codes, base


def _both(tables, codes, base, k, lut_dtype, scale=None):
    _, jnp, jax_gather_topk = _jax()
    dj, ij = jax_gather_topk(jnp.asarray(tables), jnp.asarray(codes),
                             jnp.asarray(base), k, lut_dtype=lut_dtype,
                             scale=None if scale is None
                             else jnp.asarray(scale))
    dt, it = pq_adc_gather_topk_ref(
        torch.from_numpy(tables), torch.from_numpy(codes),
        torch.from_numpy(base), k, lut_dtype,
        None if scale is None else torch.from_numpy(scale))
    return np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()


def _assert_d2(dt, dj, lut_dtype):
    if lut_dtype == "int8":
        np.testing.assert_array_equal(dt.view(np.uint32), dj.view(np.uint32))
    else:
        np.testing.assert_allclose(dt, dj, rtol=RTOL[lut_dtype])


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nq,c,m,kc,k,n_masked,scale", [
    (9, 517, 8, 64, 12, 5, None),    # C a multiple of no block
    (5, 130, 16, 256, 40, 110, None),  # k > #finite (20 finite slots)
    # one candidate, with a caller scale: at C=1 XLA folds the default
    # scale's max|t| / 127 into max|t| * (1/127), another rounding
    (3, 1, 4, 16, 1, 0, 0.05),
])
def test_plain_matches_jax_ref(lut_dtype, nq, c, m, kc, k, n_masked, scale):
    tables, codes, base = _inputs(nq * c + m, nq, c, m, kc, n_masked)
    if scale is not None:
        scale = np.full(nq, scale, np.float32)
    dj, ij, dt, it = _both(tables, codes, base, k, lut_dtype, scale)
    _assert_d2(dt, dj, lut_dtype)
    finite = np.isfinite(dj)
    np.testing.assert_array_equal(it[finite], ij[finite])


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_wrapper_on_cpu_marks_unfilled_slots(lut_dtype):
    """The CPU route of the wrapper is the plain version with the kernel's
    contract: (+inf, -1) where fewer than k candidates are finite."""
    tables, codes, base = _inputs(7, 4, 96, 4, 16, n_masked=90)
    d, i = ops.pq_adc_gather_topk(torch.from_numpy(tables),
                                  torch.from_numpy(codes),
                                  torch.from_numpy(base), 12, lut_dtype)
    dr, ir = pq_adc_gather_topk_ref(torch.from_numpy(tables),
                                    torch.from_numpy(codes),
                                    torch.from_numpy(base), 12, lut_dtype)
    inf = torch.isinf(dr)
    assert inf.any()
    assert (i[inf] == -1).all()
    assert torch.equal(i[~inf], ir[~inf])
    assert torch.equal(d, dr)
    # k above C pads the same way
    d2, i2 = ops.pq_adc_gather_topk(torch.from_numpy(tables),
                                    torch.from_numpy(codes),
                                    torch.from_numpy(base), 100, lut_dtype)
    assert d2.shape == (4, 100) and (i2[:, 96:] == -1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_exact_ties_keep_lax_order(seed):
    """Integer tables with a caller scale of 1 and a constant base make
    many candidates score exactly alike: ids must come out in lax.top_k's
    order (lower slot first among equals), not just as the same set."""
    rng = np.random.default_rng(seed)
    nq, c, m, kc, k = 6, 300, 4, 8, 50
    tables = rng.integers(-3, 4, size=(nq, m, kc)).astype(np.float32)
    codes = rng.integers(0, kc, size=(nq, c, m)).astype(np.uint8)
    base = np.zeros((nq, c), np.float32)
    scale = np.ones(nq, np.float32)
    dj, ij, dt, it = _both(tables, codes, base, k, "int8", scale)
    assert (np.diff(dj, axis=1) == 0).sum() > k     # the ties are real
    np.testing.assert_array_equal(dt.view(np.uint32), dj.view(np.uint32))
    np.testing.assert_array_equal(it, ij)


@pytest.mark.parametrize("c,k", [(40, 7), (9000, 25), (9000, 2500)])
def test_topk_smallest_matches_lax_top_k_under_ties(c, k):
    """Both selection routes (one stable sort; topk + tie repair for wide
    rows) give lax.top_k(-d2, k) exactly, including +inf entries."""
    rng = np.random.default_rng(c + k)
    d2 = rng.integers(0, 20, size=(5, c)).astype(np.float32)
    d2[:, ::7] = np.inf
    jax, jnp, _ = _jax()
    neg, idx = jax.lax.top_k(-jnp.asarray(d2), k)
    vals, sel = topk_smallest(torch.from_numpy(d2), k)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nq,c,m,kc,k", [(5, 300, 8, 1024, 20),
                                         (3, 100, 4, 512, 1)])
def test_int32_codes_match_interpret_mode_pallas(lut_dtype, nq, c, m, kc, k):
    """int32 codes (K > 256), as the TPU kernel takes them: the plain
    version and the CPU wrapper against pq_adc_gather_topk_pallas in
    interpret mode, d2 within the file's tolerance and ids equal below
    the k-th score (masked slots at both ends)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.pq_adc import pq_adc_gather_topk_pallas
    rng = np.random.default_rng(nq + kc)
    tables = (rng.uniform(size=(nq, m, kc)) * 5).astype(np.float32)
    codes = rng.integers(0, kc, size=(nq, c, m)).astype(np.int32)
    base = rng.uniform(size=(nq, c)).astype(np.float32)
    base[:, -7:] = np.inf
    dj, ij = pq_adc_gather_topk_pallas(
        jnp.asarray(tables), jnp.asarray(codes), jnp.asarray(base), k,
        block_q=8, block_n=128, interpret=True, lut_dtype=lut_dtype)
    dj, ij = np.asarray(dj), np.asarray(ij)
    order = np.lexsort((ij, dj), axis=1)
    dj, ij = (np.take_along_axis(dj, order, axis=1),
              np.take_along_axis(ij, order, axis=1))
    below = dj < dj[:, -1:]
    args = (torch.from_numpy(tables), torch.from_numpy(codes),
            torch.from_numpy(base), k, lut_dtype)
    for dt, it in (ops.pq_adc_gather_topk_plain(*args),
                   ops.pq_adc_gather_topk(*args)):
        _assert_d2(dt.numpy(), dj, lut_dtype)
        np.testing.assert_array_equal(it.numpy()[below], ij[below])


def test_wrapper_rejects_bad_inputs():
    t = torch.zeros(2, 4, 16)
    codes = torch.zeros(2, 10, 4, dtype=torch.uint8)
    base = torch.zeros(2, 10)
    with pytest.raises(ValueError, match="shape"):
        ops.pq_adc_gather_topk(t, codes[:, :, :3], base, 3)
    with pytest.raises(ValueError, match="lut_dtype"):
        ops.pq_adc_gather_topk(t, codes, base, 3, "fp8")
    with pytest.raises(ValueError, match="outside"):
        ops.pq_adc_gather_topk(t, codes, base, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_cuda_kernel_matches_plain_version(lut_dtype):
    """K1 on the card against its plain version on the same CUDA inputs:
    ids equal, int8 d2 bit-equal, f32/bf16 d2 within rtol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tables, codes, base = _inputs(11, 33, 5000, 16, 256, n_masked=700)
    dev = torch.device("cuda")
    args = (torch.from_numpy(tables).to(dev), torch.from_numpy(codes).to(dev),
            torch.from_numpy(base).to(dev))
    before = ops.pq_adc_gather_topk.launches
    d, i = ops.pq_adc_gather_topk(*args, 64, lut_dtype)
    torch.cuda.synchronize()
    assert ops.pq_adc_gather_topk.launches == before + 1
    dr, ir = ops.pq_adc_gather_topk_plain(*args, 64, lut_dtype, None)
    if lut_dtype == "int8":
        assert torch.equal(d, dr)
        assert torch.equal(i, ir)
    else:
        torch.testing.assert_close(d, dr, rtol=1e-6, atol=0)
        same = i == ir
        # ids may differ only where the two scores are a near-tie
        assert same.float().mean() > 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("m,kc,k", [(8, 1024, 64), (6, 512, 1)])
def test_cuda_int32_codes_match_plain_version(lut_dtype, m, kc, k):
    """K1 with int32 codes (K > 256) on the card against its plain version:
    int8 bit-equal, f32 / bf16 d2 within rtol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(kc + m)
    dev = torch.device("cuda")
    tables = (rng.uniform(size=(9, m, kc)) * 5).astype(np.float32)
    codes = rng.integers(0, kc, size=(9, 3001, m)).astype(np.int32)
    base = rng.uniform(size=(9, 3001)).astype(np.float32)
    base[:, -5:] = np.inf
    args = tuple(torch.from_numpy(a).to(dev) for a in (tables, codes, base))
    before = ops.pq_adc_gather_topk.launches
    d, i = ops.pq_adc_gather_topk(*args, k, lut_dtype)
    torch.cuda.synchronize()
    assert ops.pq_adc_gather_topk.launches == before + 1
    dr, ir = ops.pq_adc_gather_topk_plain(*args, k, lut_dtype, None)
    if lut_dtype == "int8":
        assert torch.equal(d, dr) and torch.equal(i, ir)
    else:
        torch.testing.assert_close(d, dr, rtol=1e-6, atol=0)
