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


def test_split_vocab_covers_every_tile():
    assert fce.split_vocab(4096, 32000) == (8, 32)     # the LM loss's call
    for t, v in ((1, 256), (63, 1000), (4096, 32000), (512, 262144),
                 (100_000, 50)):
        n, per = fce.split_vocab(t, v)
        tiles = -(-v // 128)
        assert 1 <= n <= tiles and (n - 1) * per < tiles <= n * per


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
    with pytest.raises(ValueError, match="no kernel"):
        fce.fused_ce_fwd(*(t.to("meta") for t in (h, w, labels)))
    before = fce.fused_ce_fwd.launches
    fce.fused_ce_fwd(h, w, labels)                    # CPU: the plain path
    assert fce.fused_ce_fwd.launches == before


# K6 against its plain version on the card: ragged T, a masked vocab tail,
# a ragged last vocab tile, the tied layout (D contiguous), both dtypes
GPU_CASES = [(1, 64, 256, 256, False), (63, 64, 1000, 900, False),
             (300, 2048, 1000, 1000, True), (130, 64, 32000, 32000, False),
             (70, 100, 300, 257, True)]


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
