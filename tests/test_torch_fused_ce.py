"""Port parity of kernel K6 (fused cross-entropy): its plain version
against repro.kernels.fused_ce's fused_ce_fwd (the Pallas kernel in
interpret mode) and ce_ref; fused_ce's gradients against jax.grad of the
JAX fused_ce (its custom VJP); the wrapper's CPU contract; and the CUDA
kernel against its plain version (on the card only)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels import fused_ce as fce  # noqa: E402

# the tolerance of tests/test_fused_ce.py: f32 logits and sums in another
# order (the Pallas kernel and the port's plain version both form the
# logits in f32, from f32 or bf16 inputs)
TOL = dict(rtol=1e-5, atol=1e-5)
# gradients: tests/test_fused_ce.py's tolerance for the custom VJP
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu test alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import fused_ce as jfce
    return jax, jax.numpy, jfce


def _inputs(seed, t, d, v, vocab, w_scale=0.1):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * w_scale).astype(np.float32)
    labels = rng.integers(0, vocab or v, t).astype(np.int32)
    return h, w, labels


# the four shape cases of tests/test_fused_ce.py (with the Pallas block
# sizes they use); two have a masked vocab tail
CASES = [
    (32, 16, 64, None, 16, 16),
    (64, 32, 256, 200, 32, 64),
    (48, 8, 96, None, 16, 32),
    (128, 64, 512, 500, 64, 128),
]


@pytest.mark.parametrize("t,d,v,vocab,bt,bv", CASES)
def test_plain_matches_jax(t, d, v, vocab, bt, bv):
    _, jnp, jfce = _jax()
    h, w, labels = _inputs(t + v, t, d, v, vocab)
    hj, wj, lj = jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels)
    want = np.asarray(jfce.fused_ce_fwd(hj, wj, lj, vocab=vocab, block_t=bt,
                                        block_v=bv))
    oracle = np.asarray(jfce.ce_ref(hj, wj, lj, vocab=vocab))
    ht, wt, lt = (torch.from_numpy(a) for a in (h, w, labels))
    got = fce.fused_ce_fwd(ht, wt, lt, vocab)
    assert got.dtype == torch.float32 and got.shape == (t,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    np.testing.assert_allclose(fce.ce_ref(ht, wt, lt, vocab).numpy(), oracle,
                               **TOL)
    # the vocab tile of the plain version changes only the sums' order
    np.testing.assert_allclose(
        fce.fused_ce_fwd_plain(ht, wt, lt, vocab, block_v=48).numpy(),
        oracle, **TOL)


def test_plain_bf16_matches_jax():
    """bf16 h and w: both sides upcast to f32 before the product, and a
    bf16 product is exact in f32, so the f32 tolerance holds."""
    _, jnp, jfce = _jax()
    h, w, labels = _inputs(2, 32, 16, 64, None)
    hj, wj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (h, w))
    want = np.asarray(jfce.fused_ce_fwd(hj, wj, jnp.asarray(labels),
                                        block_t=16, block_v=16))
    ht, wt = (torch.from_numpy(a).to(torch.bfloat16) for a in (h, w))
    got = fce.fused_ce_fwd(ht, wt, torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t,d,v,vocab", [(32, 16, 64, None),
                                         (64, 32, 256, 200),
                                         (40, 8, 100, 90)])
def test_grads_match_jax_custom_vjp(t, d, v, vocab):
    """dh and dw against jax.grad of the JAX fused_ce, with a per-token
    cotangent (the backward scales each row by it). V = 100 makes the
    backward's chunk gcd(4096, 100) = 4 columns."""
    jax, jnp, jfce = _jax()
    h, w, labels = _inputs(t * 3 + d, t, d, v, vocab)
    ct = np.random.default_rng(t).standard_normal(t).astype(np.float32)
    gj = jax.grad(lambda h_, w_: jnp.sum(jnp.asarray(ct) * jfce.fused_ce(
        h_, w_, jnp.asarray(labels), vocab)), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = (torch.from_numpy(ct)
            * fce.fused_ce(ht, wt, torch.from_numpy(labels), vocab)).sum()
    dh, dw = torch.autograd.grad(loss, (ht, wt))
    np.testing.assert_allclose(dh.numpy(), np.asarray(gj[0]), **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gj[1]), **GRAD_TOL)
    if vocab is not None:                # no gradient into masked columns
        assert float(dw[:, vocab:].abs().max()) == 0.0


def test_bf16_grads_keep_their_dtypes():
    h, w, labels = _inputs(4, 16, 8, 64, None)
    ht = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = fce.fused_ce(ht, wt, torch.from_numpy(labels)).sum()
    dh, dw = torch.autograd.grad(loss, (ht, wt))
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32


def test_tied_head_view():
    """A tied head is ``embed.T``: the loss and its gradient equal those
    of the contiguous (D, V) copy, and the gradient reaches the embedding
    transposed."""
    rng = np.random.default_rng(7)
    embed = torch.from_numpy(
        (rng.standard_normal((96, 16)) * 0.2).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((20, 16)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 90, 20))
    e = embed.clone().requires_grad_()
    w = embed.T.contiguous().requires_grad_()
    lv = fce.fused_ce(h, e.T, labels, 90)
    lc = fce.fused_ce(h, w, labels, 90)
    torch.testing.assert_close(lv, lc, rtol=0, atol=0)
    (ge,) = torch.autograd.grad(lv.sum(), (e,))
    (gw,) = torch.autograd.grad(lc.sum(), (w,))
    torch.testing.assert_close(ge, gw.T, rtol=0, atol=0)


def test_label_dtypes_agree():
    h, w, labels = _inputs(5, 24, 8, 64, None)
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    a = fce.fused_ce_fwd(ht, wt, torch.from_numpy(labels))
    b = fce.fused_ce_fwd(ht, wt, torch.from_numpy(labels).long())
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("route,want", [("f32", (8, 32)), ("bf16", (4, 32))])
def test_split_vocab_covers_every_tile(route, want):
    # the LM loss's call: 64 row tiles x 8 slices of 128-column tiles on
    # the f32 route (two waves of 2 blocks an SM), 32 x 4 slices of
    # 256-column tiles on the bf16 route (one wave of 1 block an SM)
    assert fce.split_vocab(4096, 32000, route) == want
    for t, v in ((1, 256), (63, 1000), (4096, 32000), (512, 262144),
                 (100_000, 50)):
        n, per = fce.split_vocab(t, v, route)
        tiles = -(-v // fce.ops._COL_TILE[route])
        assert 1 <= n <= tiles and (n - 1) * per < tiles <= n * per


@pytest.mark.parametrize("h_dtype,w_dtype,want", [
    (torch.bfloat16, torch.bfloat16, "bf16"),
    (torch.float32, torch.float32, "f32"),
    (torch.bfloat16, torch.float32, "f32"),
    (torch.float32, torch.bfloat16, "f32"),
])
def test_kernel_route(h_dtype, w_dtype, want):
    """bf16 h and w take the tensor-core kernel; f32 and mixed inputs the
    CUDA-core kernel (TF32 products would not be exact)."""
    assert fce.kernel_route(h_dtype, w_dtype) == want
    assert want in fce.ROUTES


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32])
def test_kernel_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="no kernel"):
        fce.kernel_route(dtype, torch.bfloat16)
    with pytest.raises(TypeError, match="no kernel"):
        fce.kernel_route(torch.bfloat16, dtype)


@pytest.mark.parametrize("t,d,v,tied", [(5, 100, 300, False),
                                        (5, 100, 300, True),
                                        (7, 64, 256, False),
                                        (7, 64, 256, True)])
def test_bf16_operands_keep_the_loss(t, d, v, tied):
    """The operands the bf16 kernel reads: h (T, D rounded up to 8) and the
    head untied (V contiguous, V rounded up to 8) or tied (D contiguous),
    16-byte aligned rows; aligned inputs pass as they are, and zero
    padding leaves the loss of the first V columns unchanged."""
    from repro_torch.kernels.fused_ce.ops import _bf16_operands
    h, w, labels = (torch.from_numpy(a) for a in _inputs(t + v, t, d, v,
                                                           None))
    h, w = h.to(torch.bfloat16), w.to(torch.bfloat16)
    if tied:
        w = w.T.contiguous().T                        # (D, V), D contiguous
    hb, wb, is_tied = _bf16_operands(h, w)
    assert is_tied == tied
    dp = -(-d // 8) * 8
    assert hb.shape == (t, dp) and hb.stride(1) == 1 and hb.stride(0) % 8 == 0
    assert wb.shape[0] == dp and wb.shape[1] >= v
    if tied:
        assert wb.stride(0) == 1 and wb.stride(1) % 8 == 0
    else:
        assert wb.stride(1) == 1 and wb.stride(0) % 8 == 0
        assert wb.shape[1] % 8 == 0
    if dp == d and v % 8 == 0:
        assert hb.data_ptr() == h.data_ptr() and wb.data_ptr() == w.data_ptr()
    want = fce.fused_ce_fwd_plain(h, w, labels)
    got = fce.fused_ce_fwd_plain(hb, wb[:, :v], labels)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_bad_inputs():
    h, w, labels = (torch.from_numpy(a) for a in _inputs(0, 8, 4, 32, None))
    with pytest.raises(ValueError, match="do not fit"):
        fce.fused_ce_fwd(h, w[:3], labels)
    with pytest.raises(ValueError, match="do not fit"):
        fce.fused_ce_fwd(h, w, labels[:5])
    with pytest.raises(ValueError, match="must be"):
        fce.fused_ce_fwd(h[None], w, labels)
    with pytest.raises(TypeError, match="h and w"):
        fce.fused_ce_fwd(h.half(), w, labels)
    with pytest.raises(TypeError, match="labels"):
        fce.fused_ce_fwd(h, w, labels.float())
    with pytest.raises(ValueError, match="vocab"):
        fce.fused_ce_fwd(h, w, labels, 33)
    # a meta tensor models the card (the dry-run): the launch's meta
    # kernel gives the (T,) f32 output, and counts as a launch
    before = fce.fused_ce_fwd.launches
    out = fce.fused_ce_fwd(*(t.to("meta") for t in (h, w, labels)))
    assert out.device.type == "meta" and out.shape == (h.shape[0],)
    assert out.dtype == torch.float32
    assert fce.fused_ce_fwd.launches == before + 1
    before = fce.fused_ce_fwd.launches
    fce.fused_ce_fwd(h, w, labels)                    # CPU: the plain path
    assert fce.fused_ce_fwd.launches == before


# K6 against its plain version on the card: ragged T, a masked vocab tail,
# a ragged last vocab tile, the tied layout (D contiguous), both dtypes
GPU_CASES = [(1, 64, 256, 256, False), (63, 64, 1000, 900, False),
             (300, 2048, 1000, 1000, True), (130, 64, 32000, 32000, False),
             (70, 100, 300, 257, True)]


# the bf16 route at the sizes the LM loss and Gemma3's tied head give it:
# T 1, 63 and 4096, ragged V, masked vocab tails, D not a multiple of 64
BF16_CASES = [(1, 2048, 32000, 32000, False), (63, 2048, 1000, 937, False),
              (4096, 2048, 32000, 32000, False), (4096, 64, 300, 257, True),
              (63, 2560, 5000, 4999, True), (130, 200, 1000, 1000, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("t,d,v,vocab,tied", BF16_CASES)
def test_cuda_bf16_route_matches_plain_version(t, d, v, vocab, tied,
                                               label_dtype):
    """K6's tensor-core route within K6_TOL of the plain version on untied
    and tied heads, its launch counted on the bf16 route, and a second call
    bit for bit (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, labels = (torch.from_numpy(a).cuda()
                    for a in _inputs(t + d, t, d, v, vocab, d ** -0.5))
    if tied:
        w = w.T.contiguous().T                        # (D, V), D contiguous
    h, w = h.to(torch.bfloat16), w.to(torch.bfloat16)
    labels = labels.to(label_dtype)
    before = dict(fce.fused_ce_fwd.launches_by_route)
    got = fce.fused_ce_fwd(h, w, labels, vocab)
    torch.cuda.synchronize()
    assert fce.fused_ce_fwd.launches_by_route["bf16"] == before["bf16"] + 1
    assert fce.fused_ce_fwd.launches_by_route["f32"] == before["f32"]
    want = fce.fused_ce_fwd_plain(h, w, labels, vocab)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(fce.fused_ce_fwd(h, w, labels, vocab), got,
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t,d,v,vocab,tied", GPU_CASES)
def test_cuda_kernel_matches_plain_version(dtype, t, d, v, vocab, tied):
    """K6 on the card against its plain version on the same CUDA inputs:
    f32 sums in another order (atol 1e-4 of a loss of ~ln V)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, labels = (torch.from_numpy(a).cuda()
                    for a in _inputs(t + v, t, d, v, vocab, d ** -0.5))
    if tied:
        w = w.T.contiguous().T                        # (D, V), D contiguous
    if dtype == "bf16":
        h, w = h.to(torch.bfloat16), w.to(torch.bfloat16)
    before = fce.fused_ce_fwd.launches
    got = fce.fused_ce_fwd(h, w, labels.long(), vocab)
    torch.cuda.synchronize()
    assert fce.fused_ce_fwd.launches == before + 1
    want = fce.fused_ce_fwd_plain(h, w, labels, vocab)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    again = fce.fused_ce_fwd(h, w, labels, vocab)     # int32 labels
    torch.testing.assert_close(again, got, rtol=0, atol=0)   # no atomics
