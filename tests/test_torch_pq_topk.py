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
from repro_torch.kernels.pq_adc.lut import quantize_lut  # noqa: E402
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


# K2's staged layout: (nq, N, M, K, code dtype, table values); the last
# case has int8 entries of +-127 past 256 subspaces, so the kernel's 16-bit
# lanes are flushed into int32 mid-row
LAYOUT_CASES = [
    (5, 300, 16, 256, np.uint8, "uniform"),     # nq not a multiple of 2, 4, 8
    (9, 200, 6, 64, np.uint8, "uniform"),       # M 6: one code at a time
    (3, 150, 8, 1024, np.int32, "uniform"),     # int32 codes
    (4, 120, 300, 4, np.uint8, "sign"),         # the lane flush at M 256
]


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("qb", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("nq,n,m,kc,code_dtype,values", LAYOUT_CASES)
def test_packed_layout_scores_bit_equal(lut_dtype, qb, nq, n, m, kc,
                                        code_dtype, values):
    """The plain scorer over pack_shared_tables's layout, with the kernel's
    arithmetic (int8 as biased bytes in 16-bit lanes, flushed into int32
    every 256 terms), is bit-equal to pq_adc_scores_ref: the layout loses
    nothing."""
    rng = np.random.default_rng(nq * m + qb)
    if values == "sign":
        tables = rng.choice([-1.0, 1.0], size=(nq, m, kc)).astype(np.float32)
    else:
        tables = (rng.uniform(size=(nq, m, kc)) * 5).astype(np.float32)
    codes = rng.integers(0, kc, size=(n, m)).astype(code_dtype)
    t, c = torch.from_numpy(tables), torch.from_numpy(codes)
    qt, scale = quantize_lut(t, lut_dtype)
    if values == "sign" and lut_dtype == "int8":
        assert int(qt.abs().min()) == 127           # every entry is +-127
    packed = ops.pack_shared_tables(qt, lut_dtype, qb)
    g = -(-nq // qb)
    assert tuple(packed.shape) == (g, m, kc, qb)
    assert packed.dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                            "int8": torch.uint8}[lut_dtype]
    got = ops.packed_scores(packed, scale, c, lut_dtype, nq)
    want = pq_adc_scores_ref(t, c, lut_dtype)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


def test_packed_layout_interleaves_queries():
    """Entry (g, m, code, qi) is query g * QB + qi's table entry; int8
    entries q are stored as the bytes q + 128, absent queries as 128 (a
    score of 0)."""
    assert ops.U8_BIAS == 128
    qt = torch.arange(-60, 60, dtype=torch.int8).reshape(5, 4, 6)
    qt[0, 0, :2] = torch.tensor([-127, 127], dtype=torch.int8)
    p = ops.pack_shared_tables(qt, "int8", 4)
    assert tuple(p.shape) == (2, 4, 6, 4)
    for q in range(5):
        assert torch.equal(p[q // 4, :, :, q % 4].to(torch.int16) - 128,
                           qt[q].to(torch.int16))
    assert bool((p[1, :, :, 1:] == 128).all())


def test_packed_layout_interleaves_32_queries():
    """A group of 32 int8 queries: the 32 bytes of one (m, code) are one
    vector holding query qi at byte qi (lane j of the four that share a
    row loads queries 8j .. 8j + 7); a ragged last group holds 128 for its
    absent queries."""
    rng = np.random.default_rng(32)
    nq, m, kc = 37, 3, 5
    qt = torch.from_numpy(rng.integers(-127, 128, (nq, m, kc)).astype(
        np.int8))
    p = ops.pack_shared_tables(qt, "int8", 32)
    assert tuple(p.shape) == (2, m, kc, 32) and p.is_contiguous()
    flat = p.reshape(-1)
    for q in range(nq):
        g, qi = divmod(q, 32)
        for mm in range(m):
            for code in range(kc):
                off = ((g * m + mm) * kc + code) * 32
                assert int(flat[off + qi]) - 128 == int(qt[q, mm, code])
    assert bool((p[1, :, :, nq - 32:] == 128).all())


# int8 groups where they differ from f32 and bf16's (up to 32 queries)
_QB_INT8 = {9: 16, 16: 16, 17: 32, 32: 32, 33: 32, 256: 32, 1024: 32}
# a code matrix long enough that the batch alone sets QB
_MANY_ROWS = 1 << 30


@pytest.mark.parametrize("nq,want", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                     (8, 8), (9, 8), (256, 8), (16, 8),
                                     (17, 8), (32, 8), (33, 8), (1024, 8)])
def test_queries_per_block_follow_the_batch(nq, want):
    """QB is the next power of two >= nq, at most 8 with f32 and bf16
    tables and at most 32 with int8 ones (``_QB_INT8``; ``want`` is f32 and
    bf16's) over a code matrix long enough for wide groups: a batch of one
    stages no absent query, a batch of 1,024 int8 queries takes groups of
    32."""
    for lut in ("f32", "bf16", "int8"):
        qb = _QB_INT8.get(nq, want) if lut == "int8" else want
        assert ops.shared_layout(nq, 16, 256, 64, lut, _MANY_ROWS) == \
            (qb, {"f32": "f32", "bf16": "bf16", "int8": "uint8"}[lut])


def test_int8_groups_widen_only_over_enough_rows():
    """Groups of more than 8 int8 queries only where the call scans at
    least WIDE_MIN_PAIRS (query, row) pairs: the pq cell's 1,024 queries
    over 5M rows take 32, path 2's 256 over 1M take 8; f32 and bf16 stay
    at 8 either way."""
    assert ops.WIDE_MIN_PAIRS == 1 << 29
    for nq, n, want in ((1024, 5_000_000, 32), (1024, 1 << 19, 32),
                        (1024, (1 << 19) - 1, 8), (256, 1_000_000, 8),
                        (9, 5_000_000, 8), (9, 1 << 26, 16),
                        (4, 1 << 30, 4)):
        assert ops.shared_layout(nq, 16, 256, 64, "int8", n) == \
            (want, "uint8")
        assert ops.shared_layout(nq, 16, 256, 64, "f32", n)[0] == min(want, 8)


def test_queries_per_block_shrink_to_fit_shared_memory():
    """Where a group's tables and lists do not fit a block, QB halves;
    k 1000 needs 2048-pair lists (16 KB a query). An int8 group of 32
    keeps 256-pair lists (its 128 KB of tables at M 16, K 256 leave no
    room for 512), so it takes k up to 128 and falls back below 32
    above."""
    assert ops.list_work(64) == 512 and ops.list_work(1000) == 2048
    assert ops.list_work(64, 32) == 256 and ops.list_work(128, 32) == 256
    assert ops.list_work(129, 32) == 512 and ops.list_work(64, 16) == 512
    assert ops.shared_layout(256, 16, 256, 1000, "f32", _MANY_ROWS)[0] == 4
    assert ops.shared_layout(256, 16, 256, 1000, "int8", _MANY_ROWS)[0] == 8
    assert ops.shared_layout(1024, 16, 256, 1000, "int8", _MANY_ROWS)[0] < 32
    assert ops.shared_layout(1024, 16, 256, 128, "int8", _MANY_ROWS)[0] == 32
    assert ops.shared_layout(1024, 16, 256, 129, "int8", _MANY_ROWS)[0] == 16
    assert ops.shared_layout(256, 8, 25_000, 64, "int8", _MANY_ROWS)[0] == 1
    for nq, m, kc, k, lut in ((256, 16, 256, 1000, "f32"),
                              (9, 16, 4096, 64, "bf16"),
                              (1024, 16, 256, 129, "int8"),
                              (1024, 16, 256, 1000, "int8")):
        qb, entry = ops.shared_layout(nq, m, kc, k, lut, _MANY_ROWS)
        assert ops.shared_smem_bytes(entry, qb, m, kc, k) <= 232_448
        assert ops.shared_smem_bytes(entry, 2 * qb, m, kc, k) > 232_448


def _parent_smem(lut_dtype, m, kc, k):
    """The shared memory the parent K2 needed for one query (its
    _check_smem): int8 tables at one byte, f32 and bf16 at four, and lists
    of max(1024, 2k rounded up to a power of two) pairs."""
    work = 1024
    while work < 2 * k:
        work <<= 1
    tb = -(-m * kc * (1 if lut_dtype == "int8" else 4) // 16) * 16
    return tb + 8 * work + 64


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_every_shape_the_parent_accepted_still_fits(lut_dtype):
    """No (M, K, k) that the parent K2 accepted is refused now: its layout
    at QB 1 needs no more shared memory than the parent's did."""
    for m in (1, 4, 6, 8, 16, 32, 64, 128, 300, 1024):
        for kc in (16, 256, 1024, 4096, 8192, 50_000):
            for k in (1, 64, 500, 1000, 4096, 8192):
                if _parent_smem(lut_dtype, m, kc, k) > 232_448:
                    continue
                qb, entry = ops.shared_layout(1, m, kc, k, lut_dtype,
                                              _MANY_ROWS)
                assert qb == 1
                assert ops.shared_smem_bytes(entry, 1, m, kc, k) <= \
                    _parent_smem(lut_dtype, m, kc, k)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("nq", [1, 3, 8, 9, 256])
@pytest.mark.parametrize("k", [1, 64, 1000, "N+3"])
def test_cuda_packed_layout_matches_plain_version(lut_dtype, nq, k):
    """K2 on the card on every QB its layout picks (1, 4, 8; a ragged last
    group at 9), from k 1 to past N: d2 and ids bit-equal to the plain
    version, and a second call bit for bit."""
    dev = _cuda_or_skip()
    n = 4001
    k = n + 3 if k == "N+3" else k
    tables, codes = _inputs(nq + 7, nq, n, 16, 256)
    t, c = torch.from_numpy(tables).to(dev), torch.from_numpy(codes).to(dev)
    d, i = ops.pq_adc_topk(t, c, k, lut_dtype)
    torch.cuda.synchronize()
    dr, ir = ops.pq_adc_topk_plain(t, c, k, lut_dtype)
    assert torch.equal(d, dr) and torch.equal(i, ir)
    d2, i2 = ops.pq_adc_topk(t, c, k, lut_dtype)
    assert torch.equal(d2, d) and torch.equal(i2, i)


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_cuda_largest_tables_the_parent_accepted(lut_dtype):
    """The largest (M, K) of int32 codes the parent K2 took for one query
    at k 64 (M 8): bit-equal to the plain version."""
    dev = _cuda_or_skip()
    m, k = 8, 64
    kc = 1
    while _parent_smem(lut_dtype, m, kc + 1, k) <= 232_448:
        kc += 1
    rng = np.random.default_rng(kc)
    t = torch.from_numpy((rng.uniform(size=(2, m, kc)) * 5).astype(
        np.float32)).to(dev)
    c = torch.from_numpy(rng.integers(0, kc, (3000, m)).astype(
        np.int32)).to(dev)
    d, i = ops.pq_adc_topk(t, c, k, lut_dtype)
    torch.cuda.synchronize()
    dr, ir = ops.pq_adc_topk_plain(t, c, k, lut_dtype)
    assert torch.equal(d, dr) and torch.equal(i, ir)


@pytest.mark.gpu
def test_cuda_plan_fills_whole_waves():
    """K2's plan fills whole waves of the blocks its occupancy allows, at
    the QB its layout picks (8 at most over 1M rows up to Q 512, 32 at
    Q 1,024)."""
    dev = _cuda_or_skip()
    codes = torch.zeros((2_000_000, 16), dtype=torch.uint8, device=dev)
    for nq, n, qb in ((1, 10**6, 1), (8, 10**6, 8), (64, 10**6, 8),
                      (256, 10**6, 8), (512, 10**6, 8), (1024, 10**6, 32),
                      (1024, 2 * 10**6, 32)):
        plan = ops.pq_adc_topk_plan(codes[:n], nq, 256, 64, "int8")
        assert plan["qb"] == qb == \
            ops.shared_layout(nq, 16, 256, 64, "int8", n)[0]
        assert plan["blocks_per_sm"] >= 1
        assert plan["waves"] >= 0.9 * -(-plan["waves"] // 1)
        assert plan["parts"] * plan["rows_per_part"] >= n


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


def _planted_scores(starts, ends, n, rng):
    """Scores in [0, 65535] a row, planted so that in every row part of at
    least three chunks the list counts of k 64 meet the kernel's sort
    limit exactly: K2's block of 256 threads scans 256 rows a chunk, a
    list of list_work(64) = 512 pairs holds 448 newcomers, and a list is
    sorted once its count passes 448 - 256 = 192. Chunk 0 fills the
    lists (256 newcomers: a sort); in chunk 1, 192 rows beat the new bar
    (the count ends at the limit: no sort); in chunk 2 one row does (the
    count passes it: a sort). The rest of each part is random."""
    threads, k = 256, 64
    room = ops.list_work(k) - k
    assert room - threads == 192
    s = rng.integers(0, 65536, n)
    planted = 0
    for a, b in zip(starts, ends):
        if b - a < 3 * threads + 1:
            continue
        s[a:a + threads] = 60_000 + np.arange(threads)     # bar -> 60063
        s[a + threads:a + 2 * threads] = 65_000 + np.arange(threads)
        s[a + threads:a + threads + 192] = 50_000 + np.arange(192)
        s[a + 2 * threads:a + 3 * threads] = 65_300
        s[a + 2 * threads] = 40_000
        planted += 1
    return s, planted


def test_planted_rows_meet_the_sort_limit():
    """The premise of the gpu test below, by a plain model of K2's
    selection over one row part (chunks of 256 rows, a row enters when it
    beats the k-th of its list, a sort once the count passes 192 and after
    the last chunk): the counts end chunks 0, 1 and 2 at 256, 192 (the
    limit, no sort) and 193."""
    k, threads, limit = 64, 256, 192
    n = 2000
    scores, planted = _planted_scores([0], [n], n, np.random.default_rng(3))
    assert planted == 1
    best, bar, cnt, ends = [], (np.inf, -1), 0, []
    for c0 in range(0, n, threads):
        rows = range(c0, min(n, c0 + threads))
        new = [(float(scores[r]), r) for r in rows if (scores[r], r) < bar]
        best += new
        cnt += len(new)
        ends.append(cnt)
        if cnt > limit or c0 + threads >= n:
            best = sorted(best)[:k]
            bar = best[-1] if len(best) == k else (np.inf, -1)
            cnt = 0
    assert ends[:3] == [256, 192, 193]


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "bf16"])
def test_cuda_list_counts_at_the_sort_limit(lut_dtype):
    """Rows planted so that a list's count ends a chunk exactly at the sort
    limit, then passes it by one (``_planted_scores``): K2 decides to sort
    at the chunk's barrier from the insertion that found the count at the
    limit, and its d2 and ids stay bit-equal to the plain version. M 2
    tables 256 * c0 and c1 give each row the exact score 256 * c0 + c1 in
    f32 and bf16 (int8 would round them); odd queries see the scores
    reversed."""
    dev = _cuda_or_skip()
    nq, n, k = 256, 100_000, 64
    codes = torch.zeros((n, 2), dtype=torch.uint8, device=dev)
    plan = ops.pq_adc_topk_plan(codes, nq, 256, k, lut_dtype)
    starts = np.arange(plan["parts"]) * plan["rows_per_part"]
    ends = np.minimum(starts + plan["rows_per_part"], n)
    scores, planted = _planted_scores(starts, ends, n,
                                      np.random.default_rng(17))
    assert planted >= 1
    c = np.stack([scores // 256, scores % 256], axis=1).astype(np.uint8)
    codes.copy_(torch.from_numpy(c))
    up = np.stack([256.0 * np.arange(256), np.arange(256.0)])
    tables = np.where((np.arange(nq) % 2 == 0)[:, None, None], up[None],
                      up[None, :, ::-1]).astype(np.float32)
    t = torch.from_numpy(tables).to(dev)
    d, i = ops.pq_adc_topk(t, codes, k, lut_dtype)
    torch.cuda.synchronize()
    dr, ir = ops.pq_adc_topk_plain(t, codes, k, lut_dtype)
    assert torch.equal(d, dr) and torch.equal(i, ir)


def _int8_call(t, c, k, scale=None):
    """K2 on int8 tables, checked bit for bit (d2 and ids) against the
    plain version and against a second call; returns the QB it launched,
    read from ``launches_by_qb``."""
    before = dict(ops.pq_adc_topk.launches_by_qb)
    d, i = ops.pq_adc_topk(t, c, k, "int8", scale)
    torch.cuda.synchronize()
    after = ops.pq_adc_topk.launches_by_qb
    (qb,) = [q for q in after if after[q] != before.get(q, 0)]
    assert after[qb] == before.get(qb, 0) + 1
    dr, ir = ops.pq_adc_topk_plain(t, c, k, "int8", scale)
    assert torch.equal(d, dr) and torch.equal(i, ir)
    d2, i2 = ops.pq_adc_topk(t, c, k, "int8", scale)
    assert torch.equal(d2, d) and torch.equal(i2, i)
    return qb


@pytest.mark.gpu
@pytest.mark.parametrize("nq", [16, 31, 32, 33, 1024])
@pytest.mark.parametrize("k", [1, 64, 128, 200, 1000])
def test_cuda_int8_groups_of_16_and_32_match_plain_version(nq, k,
                                                          monkeypatch):
    """int8 groups of more than 8 queries (taken here at any row count):
    QB 16 (one lane a row) at 16 queries, QB 32 (four lanes a row) from 17
    up, with a ragged group at 31 and a group of one query after a full
    one at 33; k 200 falls back to 16 and k 1000 to 8 (their lists do not
    fit beside 32 queries' tables). d2 and ids bit-equal to the plain
    version."""
    dev = _cuda_or_skip()
    monkeypatch.setattr(ops, "WIDE_MIN_PAIRS", 0)
    tables, codes = _inputs(nq + k, nq, 20_011, 16, 256)
    t, c = torch.from_numpy(tables).to(dev), torch.from_numpy(codes).to(dev)
    want = {1: 32, 64: 32, 128: 32, 200: 16, 1000: 8}[k]
    want = min(want, 16) if nq == 16 else want
    assert _int8_call(t, c, k) == want


@pytest.mark.gpu
@pytest.mark.parametrize("m,kc,code_dtype,qb", [
    (4, 512, np.int32, 32),      # a row of one 16-byte vector, int32
    (6, 300, np.int32, 32),      # one code at a time
    (8, 1024, np.int32, 16),     # two vectors; 32 queries do not fit
    (6, 256, np.uint8, 32),      # one code at a time
    (32, 64, np.uint8, 32),      # two vectors
])
def test_cuda_int8_groups_of_32_on_other_code_rows(m, kc, code_dtype, qb,
                                                   monkeypatch):
    """The 32- and 16-query groups (taken here at any row count) on rows
    that are not one 16-byte vector of uint8 codes (int32 codes for K >
    256, M not a multiple of a vector, two vectors a row): bit-equal to
    the plain version."""
    dev = _cuda_or_skip()
    monkeypatch.setattr(ops, "WIDE_MIN_PAIRS", 0)
    rng = np.random.default_rng(m * kc)
    t = torch.from_numpy((rng.uniform(size=(40, m, kc)) * 5).astype(
        np.float32)).to(dev)
    c = torch.from_numpy(rng.integers(0, kc, (20_001, m)).astype(
        code_dtype)).to(dev)
    assert _int8_call(t, c, 64) == qb


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 16])
def test_cuda_int8_exact_ties_at_32_queries(m, monkeypatch):
    """test_int8_exact_ties_keep_lax_order's ties in groups of 32 (taken
    here at any row count): integer tables with a caller scale of 1, so
    many rows score exactly alike; ids in lax.top_k's order (lower row
    first), bit-equal to the plain version, at M 4 (one code at a time)
    and M 16 (the row a chunk ahead)."""
    dev = _cuda_or_skip()
    monkeypatch.setattr(ops, "WIDE_MIN_PAIRS", 0)
    rng = np.random.default_rng(m)
    nq, n, kc, k = 40, 4000, 8, 50
    t = torch.from_numpy(rng.integers(-3, 4, (nq, m, kc)).astype(
        np.float32)).to(dev)
    c = torch.from_numpy(rng.integers(0, kc, (n, m)).astype(np.uint8)).to(dev)
    scale = torch.ones(nq, device=dev)
    dp, _ = ops.pq_adc_topk_plain(t, c, k, "int8", scale)
    assert int((dp[:, 1:] == dp[:, :-1]).sum()) > k     # the ties are real
    assert _int8_call(t, c, k, scale) == 32


@pytest.mark.gpu
def test_cuda_one_scan_launch_a_call_at_32_queries():
    """A 1,024-query int8 call over 2^19 rows (the least that takes wide
    groups) at the pq cell's M 16, K 256, k 64 takes groups of 32
    (``launches_by_qb``) and launches one scan kernel,
    ``adc_shared_select<2, 32, unsigned char>``, and its ``select_topk``
    merge passes. A profiler trace may lose a record now and then, so up
    to three traces are taken: none holds more than one scan, one holds
    exactly one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = _cuda_or_skip()
    tables, codes = _inputs(5, 1024, 1 << 19, 16, 256)
    t, c = torch.from_numpy(tables).to(dev), torch.from_numpy(codes).to(dev)
    before = ops.pq_adc_topk.launches_by_qb.get(32, 0)
    ops.pq_adc_topk(t, c, 64, "int8")
    torch.cuda.synchronize()
    assert ops.pq_adc_topk.launches_by_qb[32] == before + 1
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.pq_adc_topk(t, c, 64, "int8")
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        scans = {e.key: e.count for e in kern
                 if "adc_shared_select<" in e.key}
        seen.append(scans)
        assert sum(scans.values()) <= 1, scans
        if sum(scans.values()) == 1:
            break
    assert seen[-1] and "adc_shared_select<2, 32," in next(iter(seen[-1])), \
        seen
