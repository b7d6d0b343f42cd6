"""Port parity of the LM serving path: repro_torch.models.transformer's
prefill, decode steps and embedding against repro.models.transformer on
the same parameters (carried over by bridge.lm_params_from_arrays), for a
dense and a local/global configuration with both attention routes; the
three dense and two MoE configurations; the bridge's bf16 copy; and the
entry points' device contract."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (LM_CONFIGS, LM_SHAPES,  # noqa: E402
                                 lm_param_count)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

# f32 logits, caches and embeddings: the tolerance of
# tests/test_models_lm.py (matmuls and softmax sums in another order)
ATOL = 2e-4

# the configurations of tests/test_models_lm.py
CFG = dict(name="t", n_layers=3, d_model=48, n_heads=4, n_kv_heads=2,
           d_head=12, d_ff=96, vocab=120, tie_embeddings=False,
           seq_chunk=8, q_chunk=8, kv_chunk=8)
GEMMA = dict(name="g", n_layers=7, d_model=32, n_heads=4, n_kv_heads=2,
             d_head=8, d_ff=64, vocab=64, sliding_window=6,
             global_every=3, rope_theta_local=10_000.0,
             seq_chunk=8, q_chunk=8, kv_chunk=8)
NAMES = sorted(LM_CONFIGS)
_JAX_CONFIG_MODULES = {"tinyllama-1.1b": "tinyllama_1_1b",
                       "stablelm-1.6b": "stablelm_1_6b",
                       "gemma3-4b": "gemma3_4b",
                       "granite-moe-1b-a400m": "granite_moe_1b",
                       "olmoe-1b-7b": "olmoe_1b_7b"}


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX."""
    jax = pytest.importorskip("jax")
    from repro.models import transformer as jtf
    return jax, jax.numpy, jtf


def _jit_serving(jax, jtf, jcfg):
    """JAX's prefill, decode step and embedding for ``jcfg``, jitted (one
    compile each beats op-by-op dispatch at these sizes)."""
    return (jax.jit(lambda p, t, c: jtf.lm_prefill(p, jcfg, t, c)),
            jax.jit(lambda p, t, n, c: jtf.lm_decode_step(p, jcfg, t, n, c)),
            jax.jit(lambda p, t: jtf.lm_embed(p, jcfg, t)))


def _jax_config_module(name):
    import importlib
    return importlib.import_module(
        f"repro.configs.{_JAX_CONFIG_MODULES[name]}")


def _arrays(jax, params):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(params)[0]}


def _pair(jcfg, tcfg, seed=1):
    """JAX parameters for ``jcfg`` and their copy for ``tcfg``."""
    jax, _, jtf = _jax()
    jparams = jtf.lm_init_params(jax.random.key(seed), jcfg)
    return jparams, bridge.lm_params_from_arrays(_arrays(jax, jparams), tcfg,
                                                 device="cpu")


def _assert_cache(tc, jc):
    assert len(tc) == len(jc)
    for t, j in zip(tc, jc):
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                                       atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("kw", [CFG, GEMMA], ids=["dense", "local_global"])
def test_prefill_decode_embed_match_jax(kw, attn_impl):
    """A 17-token prompt into 24-slot caches, then three decode steps: the
    local/global config's 6-slot ring buffers wrap in both phases."""
    jax, jnp, jtf = _jax()
    jcfg = jtf.LMConfig(**kw, attn_impl=attn_impl)
    tcfg = tf.LMConfig(**kw, attn_impl=attn_impl)
    jparams, tparams = _pair(jcfg, tcfg)
    prefill, decode, embed = _jit_serving(jax, jtf, jcfg)
    rng = np.random.default_rng(len(kw) + len(attn_impl))
    toks = rng.integers(0, kw["vocab"], (2, 17))
    extra = rng.integers(0, kw["vocab"], (2, 3))

    jc = jtf.init_cache(jcfg, 2, 24)
    tc = tf.init_cache(tcfg, 2, 24, device="cpu")
    lj, jc = prefill(jparams, jnp.asarray(toks), jc)
    launches = fa.flash_attention_fwd.launches
    lt, tc = tf.lm_prefill(tparams, tcfg, torch.from_numpy(toks), tc)
    assert fa.flash_attention_fwd.launches == launches   # CPU: plain route
    assert lt.shape == (2, tcfg.vocab_padded)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    _assert_cache(tc, jc)
    for i in range(3):
        lj, jc = decode(jparams, jnp.asarray(extra[:, i]),
                        jnp.int32(17 + i), jc)
        lt, tc = tf.lm_decode_step(tparams, tcfg,
                                   torch.from_numpy(extra[:, i]), 17 + i, tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    _assert_cache(tc, jc)
    assert float(lt[:, kw["vocab"]:].max()) < -1e29   # padded vocab masked
    np.testing.assert_allclose(
        tf.lm_embed(tparams, tcfg, torch.from_numpy(toks)).numpy(),
        np.asarray(embed(jparams, jnp.asarray(toks))),
        atol=ATOL)


@pytest.mark.parametrize("kw", [CFG, GEMMA], ids=["dense", "local_global"])
def test_decode_matches_prefill(kw):
    """The port's own consistency (tests/test_models_lm.py's check): a
    decode step after a prefill gives the logits of the longer prefill."""
    cfg = tf.LMConfig(**kw)
    params = tf.lm_init_params(cfg, seed=3, device="cpu")
    toks = torch.randint(0, kw["vocab"], (2, 18),
                         generator=torch.Generator().manual_seed(4))
    _, cache = tf.lm_prefill(params, cfg, toks[:, :17],
                             tf.init_cache(cfg, 2, 24, device="cpu"))
    ld, _ = tf.lm_decode_step(params, cfg, toks[:, 17], 17, cache)
    lf, _ = tf.lm_prefill(params, cfg, toks,
                          tf.init_cache(cfg, 2, 24, device="cpu"))
    torch.testing.assert_close(ld, lf, atol=ATOL, rtol=0)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("name", NAMES)
def test_smoke_configs_match_jax(name, attn_impl):
    """Each config's SMOKE size: one prefill and one decode step (an MoE
    config on its configured dispatch combine in both)."""
    jax, jnp, jtf = _jax()
    jcfg = dataclasses.replace(_jax_config_module(name).SMOKE,
                               attn_impl=attn_impl)
    tcfg = dataclasses.replace(LM_CONFIGS[name][1], attn_impl=attn_impl)
    jparams, tparams = _pair(jcfg, tcfg, seed=0)
    prefill, decode, _ = _jit_serving(jax, jtf, jcfg)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 32))
    lj, jc = prefill(jparams, jnp.asarray(toks), jtf.init_cache(jcfg, 2, 36))
    lt, tc = tf.lm_prefill(tparams, tcfg, torch.from_numpy(toks),
                           tf.init_cache(tcfg, 2, 36, device="cpu"))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    nxt = lt[:, :tcfg.vocab].argmax(dim=-1)
    lj, _ = decode(jparams, jnp.asarray(nxt.numpy()), jnp.int32(32), jc)
    lt, _ = tf.lm_decode_step(tparams, tcfg, nxt, 32, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_jax(name):
    """CONFIG and SMOKE carry the JAX files' values field for field, and
    give the same layer runs and parameter count."""
    _, jnp, _ = _jax()
    mod = _jax_config_module(name)
    for jcfg, tcfg in zip((mod.CONFIG, mod.SMOKE), LM_CONFIGS[name]):
        jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
        assert np.dtype(jd.pop("dtype")).name == str(td.pop("dtype")).split(
            ".")[-1]
        assert jd == td
        from repro.configs.lm_family import lm_param_count as jcount
        from repro.models.transformer import layer_runs as jruns
        assert tf.layer_runs(tcfg) == jruns(jcfg)
        assert lm_param_count(tcfg) == jcount(jcfg)
    from repro.configs.lm_family import LM_SHAPES as JSHAPES
    assert LM_SHAPES == JSHAPES


def test_bridge_copies_bf16_bit_for_bit():
    jax, jnp, jtf = _jax()
    jcfg = jtf.LMConfig(**GEMMA, dtype=jnp.bfloat16)
    tcfg = tf.LMConfig(**GEMMA, dtype=torch.bfloat16)
    jparams = jtf.lm_init_params(jax.random.key(2), jcfg)
    arrays = _arrays(jax, jparams)
    tparams = bridge.lm_params_from_arrays(arrays, tcfg, device="cpu")
    assert "lm_head" not in tparams                  # tied embeddings
    got = {"['embed']": tparams["embed"],
           "['final_norm']": tparams["final_norm"]}
    for ri, run in enumerate(tparams["runs"]):
        got.update({f"['runs'][{ri}]['{k}']": t for k, t in run.items()})
    assert sorted(got) == sorted(arrays)
    for key, t in got.items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      arrays[key].view(np.int16))
    with pytest.raises(ValueError, match="expected"):    # f32 for a bf16 cfg
        bridge.lm_params_from_arrays(
            _arrays(jax, jtf.lm_init_params(jax.random.key(2),
                                            jtf.LMConfig(**GEMMA))),
            tcfg, device="cpu")


def test_entry_points_need_cuda_unless_told(monkeypatch):
    cfg = tf.LMConfig(**CFG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.lm_init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_cache(cfg, 1, 8)
    params = tf.lm_init_params(cfg, seed=0, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert params["embed"].shape == (cfg.vocab_padded, cfg.d_model)
    assert [r["wq"].shape[0] for r in params["runs"]] == [3]
    cache = tf.init_cache(cfg, 1, 8, device="cpu")
    assert cache[0]["k"].shape == (3, 1, 8, 2, 12)
    assert bool((cache[0]["pos"] == -1).all())


def test_moe_and_unknown_attention_raise():
    """An MoE config builds and serves; an unknown MoE implementation
    raises ValueError where the block runs, as JAX's moe_block does; an
    unknown attention route still raises."""
    from repro_torch.models.moe import MoEConfig
    mcfg = tf.LMConfig(**dict(CFG, d_ff=0), moe=MoEConfig(
        n_experts=4, top_k=2, d_ff=16, impl="dispatch"))
    mparams = tf.lm_init_params(mcfg, 0, device="cpu")
    assert set(mparams["runs"][0]["moe"]) == {"router", "w_gate", "w_up",
                                              "w_down"}
    assert "w_gate" not in mparams["runs"][0]
    toks = torch.zeros((1, 4), dtype=torch.long)
    assert tf.lm_embed(mparams, mcfg, toks).shape == (1, CFG["d_model"])
    bad = dataclasses.replace(mcfg, moe=dataclasses.replace(mcfg.moe,
                                                            impl="a2a"))
    with pytest.raises(ValueError, match="unknown moe impl"):
        tf.lm_embed(mparams, bad, toks)
    cfg = tf.LMConfig(**CFG, attn_impl="pallas")
    params = tf.lm_init_params(tf.LMConfig(**CFG), 0, device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        tf.lm_embed(params, cfg, torch.zeros((1, 4), dtype=torch.long))


def test_decode_past_the_cache_raises():
    cfg = tf.LMConfig(**CFG)
    params = tf.lm_init_params(cfg, 0, device="cpu")
    cache = tf.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="past the cache"):
        tf.lm_decode_step(params, cfg, torch.zeros(1, dtype=torch.long), 4,
                          cache)
