"""Port parity: the plain version of kernel K5 (causal GQA flash attention)
against repro.kernels.flash_attention's flash_attention_fwd (the Pallas
kernel in interpret mode) and attention_ref; the flash_attention
Function's gradients against jax.grad of the JAX custom VJP; the port's
layers against repro.models.layers; the wrapper's CPU contract; and the
CUDA kernel and the Function's gradients against the plain route (on the
card only)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# the tolerances of tests/test_flash_attention.py: f32 sums in another
# order; bf16 outputs carry one bf16 rounding (2^-8 relative of values
# below ~4)
F32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_ATOL = 3e-2
# on the card, beside the bf16 atol: each (query, head) row's
# ||got - want|| / ||want|| within two bf16 ulps of the row, which holds
# the long rows whose values lie below atol (chip_smoke.k5_tolerance)
BF16_ROW_REL = 2.0 ** -6


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu test alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import flash_attention as jfa
    from repro.models import layers as jlayers
    return jax.numpy, jfa, jlayers


def _qkv(seed, b, s, h, kv, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    return q, k, v


# the five shape cases of tests/test_flash_attention.py (with the Pallas
# block sizes they use)
CASES = [
    (2, 64, 4, 2, 16, None, 16, 32),
    (1, 128, 8, 8, 32, None, 32, 32),
    (2, 96, 6, 2, 8, 24, 32, 32),
    (1, 64, 4, 1, 64, 16, 16, 16),
    (1, 80, 2, 2, 8, None, 16, 16),       # non-power-of-two seq
]


@pytest.mark.parametrize("b,s,h,kv,dh,win,bq,bk", CASES)
def test_plain_matches_jax(b, s, h, kv, dh, win, bq, bk):
    jnp, jfa, _ = _jax()
    q, k, v = _qkv(s + dh, b, s, h, kv, dh)
    want = np.asarray(jfa.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=win,
        block_q=bq, block_k=bk))
    oracle = np.asarray(jfa.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), window=win))
    got = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), win)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **F32_TOL)
    ref = fa.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), window=win)
    np.testing.assert_allclose(ref.numpy(), oracle, **F32_TOL)


def test_plain_bf16_matches_jax():
    jnp, jfa, _ = _jax()
    q, k, v = _qkv(3, 1, 64, 4, 2, 16)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jfa.flash_attention_fwd(qj, kj, vj, block_q=16, block_k=16)
    oracle = np.asarray(jfa.attention_ref(qj.astype(jnp.float32),
                                          kj.astype(jnp.float32),
                                          vj.astype(jnp.float32)))
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fa.flash_attention_fwd(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), oracle, atol=BF16_ATOL)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL)


@pytest.mark.parametrize("s,window", [(1, None), (40, 1), (40, 100),
                                      (1000, 16)])
def test_plain_window_edges_match_oracle(s, window):
    """S = 1, window 1 (each row sees itself only), a window wider than S,
    and a window whose tiles lie wholly outside most rows' reach."""
    q, k, v = _qkv(s, 1, s, 4, 2, 8)
    got = fa.flash_attention_fwd_plain(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), window)
    want = fa.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    if window == 1:
        np.testing.assert_allclose(got.numpy(),
                                   np.repeat(v, 2, axis=2), **F32_TOL)


@pytest.mark.parametrize("b,s,h,kv,dh,win", [
    (1, 32, 4, 2, 8, None),              # tests/test_flash_attention.py:44
    (2, 48, 4, 1, 16, 10),
])
def test_function_grads_match_jax_custom_vjp(b, s, h, kv, dh, win):
    """The Function's q, k, v gradients of sum(out ** 2) against jax.grad
    of the JAX flash_attention (interpret-mode forward, chunked
    recompute backward). Both backwards are the chunked path's autodiff;
    the forward outputs that feed the cotangent differ by f32 summation
    order."""
    jnp, jfa, _ = _jax()
    jax = pytest.importorskip("jax")
    q, k, v = _qkv(s + dh + 1, b, s, h, kv, dh)
    gj = jax.grad(lambda q_, k_, v_: jnp.sum(jfa.flash_attention(
        q_, k_, v_, win) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention(*leaves, win)
    gt = torch.autograd.grad((out ** 2).sum(), leaves)
    assert fa.flash_attention_fwd.launches == before      # CPU: plain route
    for got, want in zip(gt, gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_function_grads_only_where_asked():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 4, 2, 8))
    k.requires_grad_()
    (gk,) = torch.autograd.grad(fa.flash_attention(q, k, v).sum(), (k,))
    want = torch.autograd.grad(
        fa.flash_attention_fwd_plain(q, k, v).sum(), (k,))[0]
    torch.testing.assert_close(gk, want, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 16, 4, 2, 8))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_fwd(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="self-attention"):
        fa.flash_attention_fwd(q, k[:, :8], v[:, :8])
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_fwd(q, k, v, 0)
    with pytest.raises(ValueError, match="fit q"):
        fa.flash_attention_fwd(q, k, v[:, :, :1])
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_fwd(*(t.to("meta") for t in (q, k, v)))
    before = fa.flash_attention_fwd.launches
    fa.flash_attention_fwd(q, k, v)                   # CPU: the plain path
    assert fa.flash_attention_fwd.launches == before


def test_rope_matches_jax_to_4096():
    jnp, _, jl = _jax()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, 3, 64)).astype(np.float32)
    pos = np.sort(rng.choice(4097, 64, replace=False)).astype(np.int32)
    pos[-1] = 4096
    for theta in (10_000.0, 1_000_000.0):
        want = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))
        got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        # XLA's exp and torch's differ by one ulp on a few of the f32
        # frequencies; at position 4096 that moves a rotation by ~2.4e-5
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got[:, :8].numpy(), want[:, :8],
                                   atol=1e-5, rtol=0)
    pos2 = rng.integers(0, 4097, (2, 64)).astype(np.int32)   # (B, S)
    want = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos2)))
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("sq,window,q_chunk,kv_chunk", [
    (1, None, 512, 1024),        # one decode query over a ring cache
    (1, 6, 512, 1024),
    (12, 5, 4, 6),               # several q and kv chunks
    (10, None, 4, 7),            # ragged chunks: the gcd fallback
])
def test_chunked_attention_matches_jax(sq, window, q_chunk, kv_chunk):
    """kv_pos holds ring-buffer positions with unwritten (-1) slots."""
    jnp, _, jl = _jax()
    rng = np.random.default_rng(sq * 7 + (window or 0))
    skv, h, kvh, dh = 14, 4, 2, 8
    q = rng.standard_normal((2, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((2, skv, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((2, skv, kvh, dh)).astype(np.float32)
    kv_pos = np.full(skv, -1, np.int32)
    kv_pos[:9] = np.array([14, 15, 16, 8, 9, 10, 11, 12, 13])   # wrapped ring
    q_pos = np.arange(17 - sq, 17, dtype=np.int32)
    want = np.asarray(jl.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)), window=window,
        q_chunk=q_chunk, kv_chunk=kv_chunk))
    got = layers.chunked_attention(
        *(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)),
        window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_norm_and_mlp_match_jax():
    jnp, _, jl = _jax()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) / 4
              for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32) / 5
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        layers.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd))).numpy(),
        np.asarray(jl.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))),
        atol=1e-5, rtol=1e-5)


def test_he_init_draws_from_its_generator():
    a = layers.he_init(torch.Generator().manual_seed(3), (64, 32), 16)
    b = layers.he_init(torch.Generator().manual_seed(3), (64, 32), 16,
                       torch.bfloat16)
    assert torch.equal(a.to(torch.bfloat16), b)
    assert abs(float(a.std()) - 0.25) < 0.02


@pytest.mark.parametrize("dh", fa.SUPPORTED_HEAD_DIMS)
def test_kernel_route_is_a_function_of_dtype_and_head_dim(dh):
    """bf16 takes the tensor-core kernel at every supported dh, dh 8
    included (the kernel pads it to the mma's k of 16 itself: the gpu
    edge case at dh 8 checks that), f32 the CUDA-core kernel; no other
    dtype or head dim has a kernel. No card needed."""
    assert fa.kernel_route(torch.bfloat16, dh) == "mma_bf16"
    assert fa.kernel_route(torch.float32, dh) == "simt_f32"
    with pytest.raises(TypeError, match="dtype"):
        fa.kernel_route(torch.float16, dh)
    with pytest.raises(ValueError, match="head dims"):
        fa.kernel_route(torch.bfloat16, dh + 4)
    assert set(fa.flash_attention_fwd.launches_by_route) == set(fa.ROUTES)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kv,dh,window", [
    (2, 80, 4, 2, 8, None), (1, 300, 8, 1, 64, 16), (1, 257, 4, 4, 128, 1),
    (1, 200, 8, 4, 256, 1024), (1, 1, 2, 2, 32, None),
    (2, 80, 4, 2, 16, 24), (1, 4096, 32, 4, 64, None)])
def test_cuda_kernel_matches_plain_version(dtype, b, s, h, kv, dh, window):
    """K5 on the card against its plain version on the same CUDA inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = (torch.from_numpy(a).cuda() for a in _qkv(9, b, s, h, kv, dh))
    if dtype == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    before = fa.flash_attention_fwd.launches
    route = fa.kernel_route(q.dtype, dh)
    by_route = fa.flash_attention_fwd.launches_by_route[route]
    got = fa.flash_attention_fwd(q, k, v, window)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert fa.flash_attention_fwd.launches_by_route[route] == by_route + 1
    assert got.dtype == q.dtype
    z = torch.zeros((1, 4, 2, 12), dtype=q.dtype, device="cuda")
    with pytest.raises(ValueError, match="head dims"):   # no dh 12 instance
        fa.flash_attention_fwd(z, z, z)
    want = fa.flash_attention_fwd_plain(q, k, v, window)
    if dtype == "f32":
        torch.testing.assert_close(got, want, **F32_TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=BF16_ATOL, rtol=0)
        rows = (torch.linalg.vector_norm((got - want).float(), dim=-1)
                / torch.linalg.vector_norm(want.float(), dim=-1))
        assert float(rows.max()) <= BF16_ROW_REL


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 64])
def test_cuda_function_grads_match_plain_route(window):
    """The Function (K5 forward) against the all-plain route (chunked
    forward and backward) on the card, at TinyLlama's heads. With a linear
    loss the cotangent does not depend on the forward output, and both
    backwards are the same chunked recompute: the gradients agree to the
    f32 rounding of one route's sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in _qkv(11, 1, 600, 32, 4, 64))
    r = torch.from_numpy(_qkv(12, 1, 600, 32, 4, 64)[0]).cuda()
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_fwd_plain):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, window)
        grads.append(torch.autograd.grad((out.float() * r).sum(), leaves))
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=1e-6 * float(want.abs().max()) + 1e-6)
