"""Port parity: the plain version of kernel K2 (shared-codes ADC top-k)
against repro.kernels.pq_adc's pq_adc_topk_ref and, in interpret mode,
pq_adc_topk_pallas; the wrapper's CPU contract; and the CUDA kernel
against its plain version (on the card only)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels.pq_adc import ops  # noqa: E402
from repro_torch.kernels.pq_adc.ref import (pq_adc_scores_ref,  # noqa: E402
                                            pq_adc_topk_ref)

# f32 and bf16: the kernel, the plain version and the JAX reference all add
# the M terms from 0 in ascending m, so scores agree to the last bit; the
# tolerance allows for XLA reassociating the sum, which it has not done
RTOL = 1e-6


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu test alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.pq_adc import pq_adc_topk_pallas, pq_adc_topk_ref
    return jax.numpy, pq_adc_topk_ref, pq_adc_topk_pallas


def _inputs(seed, nq, n, m, kc, scale=5.0):
    rng = np.random.default_rng(seed)
    tables = (rng.uniform(size=(nq, m, kc)) * scale).astype(np.float32)
    codes = rng.integers(0, kc, size=(n, m)).astype(np.uint8)
    return tables, codes


def _lex(d2, ids):
    """Each row's (d2, id) pairs in lexicographic order: the order of
    lax.top_k, whatever order among equal scores a kernel emitted."""
    order = np.lexsort((ids, d2), axis=1)
    return (np.take_along_axis(d2, order, axis=1),
            np.take_along_axis(ids, order, axis=1))


def _assert_d2(dt, dj, lut_dtype):
    if lut_dtype == "int8":
        np.testing.assert_array_equal(dt.view(np.uint32), dj.view(np.uint32))
    else:
        np.testing.assert_allclose(dt, dj, rtol=RTOL)


CASES = [
    (9, 517, 8, 64, 12),      # N a multiple of no block
    (5, 300, 16, 256, 40),    # byte codes, the engine's M
    (1, 700, 4, 16, 7),       # one query
]


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nq,n,m,kc,k", CASES)
def test_plain_matches_jax_ref(lut_dtype, nq, n, m, kc, k):
    jnp, jax_topk_ref, _ = _jax()
    tables, codes = _inputs(nq * n + m, nq, n, m, kc)
    dj, ij = jax_topk_ref(jnp.asarray(tables), jnp.asarray(codes), k,
                          lut_dtype=lut_dtype)
    dt, it = ops.pq_adc_topk_plain(torch.from_numpy(tables),
                                   torch.from_numpy(codes), k, lut_dtype)
    _assert_d2(dt.numpy(), np.asarray(dj), lut_dtype)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nq,n,m,kc,k", CASES[:2])
def test_plain_matches_interpret_mode_pallas(lut_dtype, nq, n, m, kc, k):
    """The TPU kernel itself, run in interpret mode: the same d2, and the
    same ids below the k-th score. Its running top-k evicts by position, so
    it can emit equal scores out of id order and, among rows tied at the
    k-th score, keep a higher row than lax.top_k (int8 ties at M=16,
    K=256 show it); the port keeps lax.top_k's, as the test above holds."""
    jnp, _, pallas = _jax()
    tables, codes = _inputs(nq + n, nq, n, m, kc)
    dj, ij = pallas(jnp.asarray(tables), jnp.asarray(codes), k, block_q=8,
                    block_n=128, interpret=True, lut_dtype=lut_dtype)
    dj, ij = _lex(np.asarray(dj), np.asarray(ij))
    dt, it = ops.pq_adc_topk(torch.from_numpy(tables),
                             torch.from_numpy(codes), k, lut_dtype)
    _assert_d2(dt.numpy(), dj, lut_dtype)
    below = dj < dj[:, -1:]
    np.testing.assert_array_equal(it.numpy()[below], ij[below])


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nq,n,m,kc,k", [(5, 300, 8, 1024, 20),
                                         (3, 200, 4, 512, 1)])
def test_int32_codes_match_interpret_mode_pallas(lut_dtype, nq, n, m, kc, k):
    """int32 codes (K > 256), as the TPU kernel takes them: the same d2 and
    the same ids below the k-th score as pq_adc_topk_pallas in interpret
    mode, on both the plain version and the CPU wrapper."""
    jnp, _, pallas = _jax()
    rng = np.random.default_rng(nq + kc)
    tables = (rng.uniform(size=(nq, m, kc)) * 5).astype(np.float32)
    codes = rng.integers(0, kc, size=(n, m)).astype(np.int32)
    dj, ij = pallas(jnp.asarray(tables), jnp.asarray(codes), k, block_q=8,
                    block_n=128, interpret=True, lut_dtype=lut_dtype)
    dj, ij = _lex(np.asarray(dj), np.asarray(ij))
    below = dj < dj[:, -1:]
    t, c = torch.from_numpy(tables), torch.from_numpy(codes)
    for dt, it in (ops.pq_adc_topk_plain(t, c, k, lut_dtype),
                   ops.pq_adc_topk(t, c, k, lut_dtype)):
        _assert_d2(dt.numpy(), dj, lut_dtype)
        np.testing.assert_array_equal(it.numpy()[below], ij[below])


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_exact_ties_keep_lax_order(seed):
    """Integer tables with a caller scale of 1 make many rows score exactly
    alike: ids come out in lax.top_k's order (lower row first), d2 is
    bit-equal."""
    jnp, jax_topk_ref, _ = _jax()
    rng = np.random.default_rng(seed)
    nq, n, m, kc, k = 6, 400, 4, 8, 50
    tables = rng.integers(-3, 4, size=(nq, m, kc)).astype(np.float32)
    codes = rng.integers(0, kc, size=(n, m)).astype(np.uint8)
    scale = np.ones(nq, np.float32)
    dj, ij = jax_topk_ref(jnp.asarray(tables), jnp.asarray(codes), k,
                          lut_dtype="int8", scale=jnp.asarray(scale))
    dj, ij = np.asarray(dj), np.asarray(ij)
    assert (np.diff(dj, axis=1) == 0).sum() > k     # the ties are real
    dt, it = ops.pq_adc_topk(torch.from_numpy(tables),
                             torch.from_numpy(codes), k, "int8",
                             torch.from_numpy(scale))
    np.testing.assert_array_equal(dt.numpy().view(np.uint32),
                                  dj.view(np.uint32))
    np.testing.assert_array_equal(it.numpy(), ij)


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_wrapper_on_cpu_pads_k_above_n(lut_dtype):
    """The CPU route is the plain version with the kernel's contract:
    k > N pads with (+inf, -1); the filled part is pq_adc_topk_ref's."""
    tables, codes = _inputs(3, 4, 30, 4, 16)
    t, c = torch.from_numpy(tables), torch.from_numpy(codes)
    d, i = ops.pq_adc_topk(t, c, 45, lut_dtype)
    dr, ir = pq_adc_topk_ref(t, c, 30, lut_dtype)
    assert d.shape == (4, 45) and i.dtype == torch.int64
    assert torch.equal(d[:, :30], dr) and torch.equal(i[:, :30], ir)
    assert bool(torch.isinf(d[:, 30:]).all()) and bool((i[:, 30:] == -1).all())
    # the scores behind the ids
    scores = pq_adc_scores_ref(t, c, lut_dtype)
    assert torch.equal(torch.gather(scores, 1, i[:, :30]), d[:, :30])


def test_wrapper_rejects_bad_inputs():
    t = torch.zeros(2, 4, 16)
    codes = torch.zeros(10, 4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="shape"):
        ops.pq_adc_topk(t, codes[:, :3], 3)
    with pytest.raises(ValueError, match="expected"):
        ops.pq_adc_topk(t, codes[None], 3)
    with pytest.raises(ValueError, match="lut_dtype"):
        ops.pq_adc_topk(t, codes, 3, "fp8")
    with pytest.raises(ValueError, match="outside"):
        ops.pq_adc_topk(t, codes, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_cuda_kernel_matches_plain_version(lut_dtype):
    """K2 on the card against its plain version on the same CUDA inputs:
    d2 and ids bit-equal (ragged N, Q not a multiple of the block's
    queries, several row blocks per query)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tables, codes = _inputs(11, 13, 50_003, 16, 256)
    dev = torch.device("cuda")
    t, c = torch.from_numpy(tables).to(dev), torch.from_numpy(codes).to(dev)
    before = ops.pq_adc_topk.launches
    d, i = ops.pq_adc_topk(t, c, 64, lut_dtype)
    torch.cuda.synchronize()
    assert ops.pq_adc_topk.launches == before + 1
    dr, ir = ops.pq_adc_topk_plain(t, c, 64, lut_dtype)
    assert torch.equal(d, dr)
    assert torch.equal(i, ir)


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("m,kc,k", [(8, 1024, 64), (6, 512, 1)])
def test_cuda_int32_codes_match_plain_version(lut_dtype, m, kc, k):
    """K2 with int32 codes (K > 256) on the card: d2 and ids bit-equal to
    the plain version (16-byte code loads at M 8, one code at a time at M
    6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(kc + m)
    dev = torch.device("cuda")
    t = torch.from_numpy((rng.uniform(size=(7, m, kc)) * 5).astype(
        np.float32)).to(dev)
    c = torch.from_numpy(rng.integers(0, kc, (20_001, m)).astype(
        np.int32)).to(dev)
    before = ops.pq_adc_topk.launches
    d, i = ops.pq_adc_topk(t, c, k, lut_dtype)
    torch.cuda.synchronize()
    assert ops.pq_adc_topk.launches == before + 1
    dr, ir = ops.pq_adc_topk_plain(t, c, k, lut_dtype)
    assert torch.equal(d, dr) and torch.equal(i, ir)
