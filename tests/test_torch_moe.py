"""Port parity of the MoE block and the MoE LMs: repro_torch.models.moe's
moe_block against repro.models.moe's for every implementation (dense,
dispatch with and without dropped assignments, ep), the expert ids
(a zero router's all-tied case included) and the aux loss; the bridge's
copy of an MoE LM (the f32 router beside bf16 experts) and of its AdamW
state; granite's and olmoe's SMOKE LMs (prefill, caches, decode on the
dense combine, lm_embed, lm_loss with the router aux term and its
gradients) against JAX; and, on the card, dispatch repeating bit for
bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch import bridge  # noqa: E402
from repro_torch._tree import keyed_leaves  # noqa: E402
from repro_torch.configs import LM_CONFIGS, shape_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

# f32: JAX's own tolerance for dense against dispatch
# (tests/test_models_lm.py::test_moe_dense_equals_dispatch_no_drop)
F32_ATOL = 1e-5
AUX_RTOL = 1e-6
# bf16: the same bf16 operands in both packages; the expert matmuls
# accumulate in f32 and round to bf16 once, in another order, JAX rounds
# its silu and gate products to bf16 where the port keeps f32, and the K
# gated contributions are rounded and summed in bf16 in the same order.
# Each output row may then move by a few bf16 ulps (2^-8 relative): 2^-6
# of the row's norm (measured 0.009)
BF16_ROW_REL = 2.0 ** -6
# the SMOKE LMs: the tolerance of tests/test_torch_lm.py and of
# tests/test_torch_train.py
LM_ATOL = 2e-4
F32_LOSS_RTOL = 1e-5
F32_GRAD_REL = 1e-5
MOE_NAMES = ["granite-moe-1b-a400m", "olmoe-1b-7b"]
_JAX_CONFIG_MODULES = {"granite-moe-1b-a400m": "granite_moe_1b",
                       "olmoe-1b-7b": "olmoe_1b_7b"}


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu test alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.models import moe as jmoe
    return jax, jax.numpy, jmoe


def _arrays(jax, tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tensor(a):
    return bridge._tensor(np.asarray(a))


@pytest.fixture(scope="module")
def block_params():
    """JAX MoE parameters for (E, D, F) and their port copy, one layer."""
    cache = {}

    def get(e, k, d, f, dtype="f32", zero_router=False):
        key = (e, k, d, f, dtype, zero_router)
        if key not in cache:
            jax, jnp, jmoe = _jax()
            jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
            mc = jmoe.MoEConfig(n_experts=e, top_k=k, d_ff=f)
            p = jax.tree.map(lambda a: a[0], jmoe.init_moe_params(
                jax.random.key(0), mc, d, 1, jdt))
            if zero_router:
                p["router"] = jnp.zeros_like(p["router"])
            cache[key] = (p, {n: _tensor(a) for n, a in p.items()})
        return cache[key]

    return get


# (E, K, D, F, B, S, impl, capacity_factor): the no-drop cases of JAX's
# test, the SMOKE configs' experts, drops at cf 0.1 and 1.25 (64 tokens
# over 8 experts top-2: some expert gets more than its 24 slots)
_BLOCK_CASES = [
    (4, 2, 24, 16, 2, 10, "dense", 1.25),
    (4, 2, 24, 16, 2, 10, "dispatch", 8.0),
    (4, 2, 24, 16, 2, 10, "ep", 8.0),
    (8, 2, 64, 32, 2, 32, "dispatch", 2.0),
    (2, 2, 12, 8, 1, 64, "dispatch", 0.1),
    (8, 2, 16, 8, 1, 64, "dispatch", 1.25),
    (8, 3, 16, 8, 2, 40, "dense", 1.25),
]


def moe_jit(jax, jmoe, jmc):
    return jax.jit(lambda x, p: jmoe.moe_block(x, p, jmc))


def _cases_ids():
    return [f"E{c[0]}k{c[1]}T{c[4] * c[5]}-{c[6]}-cf{c[7]}"
            for c in _BLOCK_CASES]


@pytest.mark.parametrize("case", _BLOCK_CASES, ids=_cases_ids())
def test_moe_block_matches_jax_f32(block_params, case):
    """y within 1e-5, the expert ids equal, aux within rtol 1e-6; for
    dispatch, the assignments past capacity are the ones a count over the
    expert ids gives, and JAX drops the same."""
    e, k, d, f, b, s, impl, cf = case
    jax, jnp, jmoe = _jax()
    jp, tp = block_params(e, k, d, f)
    jmc = jmoe.MoEConfig(n_experts=e, top_k=k, d_ff=f, impl=impl,
                         capacity_factor=cf)
    tmc = moe.MoEConfig(n_experts=e, top_k=k, d_ff=f, impl=impl,
                        capacity_factor=cf)
    x = np.random.default_rng(e * 100 + s).normal(size=(b, s, d)).astype(
        np.float32)
    yj, aj = moe_jit(jax, jmoe, jmc)(jnp.asarray(x), jp)
    yt, at = moe.moe_block(torch.from_numpy(x), tp, tmc)
    assert yt.dtype == torch.float32 and yt.shape == (b, s, d)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=F32_ATOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=AUX_RTOL)
    x2 = x.reshape(-1, d)
    _, ij, _ = jmoe._route(jnp.asarray(x2), jp["router"], jmc)
    tv, ti, _ = moe._route(torch.from_numpy(x2), tp["router"], tmc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ij))
    if impl != "dense":
        cap = moe.capacity(b * s, tmc)
        *_, valid, _, _ = moe._dispatch_tables(torch.from_numpy(x2), tmc, tv,
                                               ti, cap)
        counts = np.bincount(ti.numpy().ravel(), minlength=e)
        dropped = int(np.maximum(counts - cap, 0).sum())
        assert int((~valid).sum()) == dropped
        if cf < 1.0:
            assert dropped > 0


def test_zero_router_ties_keep_the_lowest_experts(block_params):
    """A zero router makes every probability 1/E: lax.top_k keeps experts
    0..K-1 in order, and so must the port (torch.topk promises no order
    among ties)."""
    jax, jnp, jmoe = _jax()
    e, k, d, f = 8, 3, 16, 8
    jp, tp = block_params(e, k, d, f, zero_router=True)
    x = np.random.default_rng(5).normal(size=(1, 24, d)).astype(np.float32)
    for impl in ("dense", "dispatch"):
        jmc = jmoe.MoEConfig(n_experts=e, top_k=k, d_ff=f, impl=impl,
                             capacity_factor=8.0)
        tmc = moe.MoEConfig(n_experts=e, top_k=k, d_ff=f, impl=impl,
                            capacity_factor=8.0)
        _, ij, aj = jmoe._route(jnp.asarray(x[0]), jp["router"], jmc)
        tv, ti, at = moe._route(torch.from_numpy(x[0]), tp["router"], tmc)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(ti.numpy(),
                                      np.broadcast_to(np.arange(k), (24, k)))
        np.testing.assert_allclose(tv.numpy(), 1.0 / k, rtol=1e-6)
        np.testing.assert_allclose(float(at), float(aj), rtol=AUX_RTOL)
        yj, _ = jmoe.moe_block(jnp.asarray(x), jp, jmc)
        yt, _ = moe.moe_block(torch.from_numpy(x), tp, tmc)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=F32_ATOL)


def test_top_k_is_lax_top_k_on_ties():
    jax, jnp, _ = _jax()
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0],
                  [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    for k in (1, 3, 6):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = moe.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_moe_block_bf16_within_rounding(block_params, impl):
    """bf16 activations and experts, the f32 router: the expert ids equal
    JAX's, each token's output within BF16_ROW_REL of JAX's."""
    jax, jnp, jmoe = _jax()
    e, k, d, f = 8, 2, 64, 32
    jp, tp = block_params(e, k, d, f, dtype="bf16")
    assert tp["router"].dtype == torch.float32
    assert tp["w_gate"].dtype == torch.bfloat16
    jmc = jmoe.MoEConfig(n_experts=e, top_k=k, d_ff=f, impl=impl,
                         capacity_factor=4.0)
    tmc = moe.MoEConfig(n_experts=e, top_k=k, d_ff=f, impl=impl,
                        capacity_factor=4.0)
    x = np.random.default_rng(9).normal(size=(2, 32, d)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = _tensor(np.asarray(xj))
    yj, aj = moe_jit(jax, jmoe, jmc)(xj, jp)
    yt, at = moe.moe_block(xt, tp, tmc)
    assert yt.dtype == torch.bfloat16
    want = np.asarray(yj).astype(np.float32)
    got = yt.float().numpy()
    rel = (np.linalg.norm(got - want, axis=-1)
           / np.linalg.norm(want, axis=-1)).max()
    assert rel <= BF16_ROW_REL, rel
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    _, ij, _ = jmoe._route(xj.reshape(-1, d), jp["router"], jmc)
    _, ti, _ = moe._route(xt.reshape(-1, d), tp["router"], tmc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ij))


def test_unknown_impl_raises(block_params):
    _, tp = block_params(4, 2, 24, 16)
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe_block(torch.zeros((1, 2, 24)), tp,
                      moe.MoEConfig(n_experts=4, top_k=2, d_ff=16,
                                    impl="a2a"))


def _jax_config(name):
    import importlib
    return importlib.import_module(
        f"repro.configs.{_JAX_CONFIG_MODULES[name]}")


def _lm_pair(jcfg, tcfg, seed=0):
    jax, _, _ = _jax()
    from repro.models import transformer as jtf
    jparams = jax.jit(lambda key: jtf.lm_init_params(key, jcfg))(
        jax.random.key(seed))
    arrays = _arrays(jax, jparams)
    return jtf, jparams, arrays, bridge.lm_params_from_arrays(
        arrays, tcfg, device="cpu")


def test_bridge_copies_an_moe_lm_bit_for_bit():
    """granite's SMOKE in bf16: every leaf carried across bit for bit, the
    router f32 beside bf16 experts; a router in bf16 is refused."""
    jax, jnp, _ = _jax()
    name = "granite-moe-1b-a400m"
    jcfg = dataclasses.replace(_jax_config(name).SMOKE, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(LM_CONFIGS[name][1], dtype=torch.bfloat16)
    _, _, arrays, tparams = _lm_pair(jcfg, tcfg)
    got = dict(keyed_leaves(tparams))
    assert sorted(got) == sorted(arrays)
    for key, t in got.items():
        want = arrays[key]
        assert t.dtype == (torch.float32 if key.endswith("['router']")
                           else torch.bfloat16), key
        np.testing.assert_array_equal(
            t.view(torch.int16 if t.dtype == torch.bfloat16
                   else torch.int32).numpy(),
            want.view(np.int16 if want.dtype.itemsize == 2 else np.int32))
    bad = dict(arrays)
    bad["['runs'][0]['moe']['router']"] = \
        arrays["['runs'][0]['moe']['router']"].astype(jnp.bfloat16)
    with pytest.raises(ValueError, match="expected"):
        bridge.lm_params_from_arrays(bad, tcfg, device="cpu")


def test_opt_state_bridge_covers_moe_parameters():
    """One JAX AdamW update over an MoE LM's parameters; its state carried
    across with opt_state_from_arrays (unchanged) holds every MoE leaf's
    moments bit for bit."""
    jax, jnp, _ = _jax()
    from repro.optim import AdamWConfig, adamw_update, init_opt_state
    name = "olmoe-1b-7b"
    jcfg = _jax_config(name).SMOKE
    tcfg = LM_CONFIGS[name][1]
    _, jparams, _, tparams = _lm_pair(jcfg, tcfg)
    grads = jax.tree.map(lambda a: jnp.full_like(a, 0.01), jparams)
    _, jopt = jax.jit(lambda g, p: adamw_update(
        g, init_opt_state(p), p, AdamWConfig()))(grads, jparams)
    arrays = _arrays(jax, jopt)
    topt = bridge.opt_state_from_arrays(arrays, tparams, device="cpu")
    moe_keys = [k for k, _ in keyed_leaves(topt) if "['moe']" in k]
    assert len(moe_keys) == 2 * 4      # m and v of router, w_gate/up/down
    for key, t in keyed_leaves(topt):
        np.testing.assert_array_equal(t.numpy(), arrays[key])


@pytest.fixture(scope="module")
def jax_serving():
    """JAX's prefill (configured impl), decode (dense, as serving runs
    it) and embedding for a SMOKE config, jitted once a config."""
    cache = {}

    def get(name):
        if name not in cache:
            jax, jnp, _ = _jax()
            from repro.configs.lm_family import _with_moe_impl
            jcfg = _jax_config(name).SMOKE
            tcfg = LM_CONFIGS[name][1]
            jtf, jparams, _, tparams = _lm_pair(jcfg, tcfg, seed=1)
            jdec = _with_moe_impl(jcfg, "dense")
            cache[name] = (jax, jnp, jtf, jcfg, tcfg, jparams, tparams, (
                jax.jit(lambda p, t, c: jtf.lm_prefill(p, jcfg, t, c)),
                jax.jit(lambda p, t, n, c: jtf.lm_decode_step(p, jdec, t, n,
                                                              c)),
                jax.jit(lambda p, t: jtf.lm_embed(p, jcfg, t))))
        return cache[name]

    return get


@pytest.mark.parametrize("name", MOE_NAMES)
def test_smoke_moe_lm_serving_matches_jax(jax_serving, name):
    """A 21-token prompt into 28-slot caches on the configured dispatch
    combine, then four greedy decode steps on the dense one
    (``shape_config(cfg, "decode")``): logits, caches and lm_embed at
    f32 atol 2e-4."""
    jax, jnp, jtf, jcfg, tcfg, jparams, tparams, (prefill, decode, embed) \
        = jax_serving(name)
    tdec = shape_config(tcfg, "decode")
    assert tdec.moe.impl == "dense" and tcfg.moe.impl == "dispatch"
    assert shape_config(tcfg, "prefill") is tcfg
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 21))
    jc = jtf.init_cache(jcfg, 2, 28)
    tc = tf.init_cache(tcfg, 2, 28, device="cpu")
    lj, jc = prefill(jparams, jnp.asarray(toks), jc)
    lt, tc = tf.lm_prefill(tparams, tcfg, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LM_ATOL)
    for i in range(4):
        nxt = lt[:, :tcfg.vocab].argmax(dim=-1)
        lj, jc = decode(jparams, jnp.asarray(nxt.numpy()), jnp.int32(21 + i),
                        jc)
        lt, tc = tf.lm_decode_step(tparams, tdec, nxt, 21 + i, tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LM_ATOL)
    for t, j in zip(tc, jc):
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                                       atol=LM_ATOL)
    np.testing.assert_allclose(
        tf.lm_embed(tparams, tcfg, torch.from_numpy(toks)).numpy(),
        np.asarray(embed(jparams, jnp.asarray(toks))), atol=LM_ATOL)


def _batch(vocab, b=2, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def jax_losses():
    """JAX's SMOKE loss and gradients, one jit compile a config."""
    cache = {}

    def get(name):
        if name not in cache:
            jax, jnp, _ = _jax()
            jcfg = _jax_config(name).SMOKE
            jtf, jparams, arrays, _ = _lm_pair(jcfg, LM_CONFIGS[name][1])
            jb = {k: jnp.asarray(v) for k, v in _batch(256).items()}
            jloss, jgrads = jax.jit(jax.value_and_grad(
                lambda p: jtf.lm_train_forward(p, jcfg, jb)))(jparams)
            cache[name] = (float(jloss), arrays, _arrays(jax, jgrads))
        return cache[name]

    return get


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_lm_loss_and_grads_match_jax(jax_losses, name, remat):
    """lm_loss with the router aux term (dispatch, the SMOKE capacity) and
    its gradient in every leaf, the router's included, against jax.grad;
    under torch.utils.checkpoint and without. The aux term is there: the
    loss without it differs by more than the tolerance."""
    jloss, arrays, want = jax_losses(name)
    tcfg = dataclasses.replace(LM_CONFIGS[name][1], remat=remat)
    tparams = bridge.lm_params_from_arrays(arrays, tcfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(256).items()}
    loss, grads = adamw.value_and_grad(
        lambda p, b: tf.lm_train_forward(p, tcfg, b), tparams, tb)
    np.testing.assert_allclose(float(loss), jloss, rtol=F32_LOSS_RTOL)
    got = dict(keyed_leaves(grads))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        rel = np.linalg.norm(g.numpy() - want[key]) / np.linalg.norm(
            want[key])
        assert rel <= F32_GRAD_REL, (key, rel)
    no_aux = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, router_aux_weight=0.0))
    with torch.no_grad():
        plain = tf.lm_loss(tparams, no_aux, tb["tokens"], tb["labels"])
    assert abs(float(loss) - float(plain)) > 100 * F32_LOSS_RTOL * float(loss)


@pytest.mark.gpu
def test_cuda_dispatch_repeats_bit_for_bit():
    """dispatch twice on the card on one input (bf16, granite's experts,
    4,096 tokens): the same output bit for bit (the combine adds each
    token's contributions in a fixed order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    mc = moe.MoEConfig(n_experts=32, top_k=8, d_ff=512, impl="dispatch")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {k: v[0] for k, v in moe.init_moe_params(gen, mc, 1024, 1,
                                                 torch.bfloat16).items()}
    x = torch.randn((4, 1024, 1024), generator=gen, device=dev).to(
        torch.bfloat16)
    a, aux_a = moe.moe_block(x, p, mc)
    b, aux_b = moe.moe_block(x, p, mc)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert bool(torch.isfinite(a.float()).all())
