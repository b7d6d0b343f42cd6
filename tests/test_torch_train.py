"""Port parity of the LM training path: repro_torch's lm_loss and its
gradients against repro.models.transformer's lm_loss and jax.grad (the
parameters carried over by bridge.lm_params_from_arrays), for TinyLlama's
and Gemma3-4B's SMOKE sizes on both attention routes with remat on and
off; one AdamW step, the schedule and clipping against repro.optim (the
moments carried over by bridge.opt_state_from_arrays); the int8
error-feedback compression; the data pipeline; checkpoints; restarts; the
arch registry; and the train launcher."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch import bridge  # noqa: E402
from repro_torch._tree import keyed_leaves  # noqa: E402
from repro_torch.configs import LM_CONFIGS  # noqa: E402
from repro_torch.configs.registry import (ARCH_MODULES,  # noqa: E402
                                          NOT_PORTED, config_module)
from repro_torch.data import deterministic_shard, lm_token_batches  # noqa
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_ce as fce  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.runtime import (FailureInjector,  # noqa: E402
                                 checkpoint_step, latest_checkpoint,
                                 restore_checkpoint, run_with_restarts,
                                 save_checkpoint)

# f32: the losses agree to ~1e-7 relative and every gradient leaf to
# ~2e-6 in relative L2 (matmuls and reductions summed in another order)
F32_LOSS_RTOL = 1e-5
F32_GRAD_REL = 1e-5
# bf16: JAX rounds the logits to bf16 before its f32 CE, K6 forms them in
# f32 from the same bf16 inputs; and the two frameworks round the bf16
# activations at other places. Measured at SMOKE size: |dloss| 1.4e-3,
# gradient leaves within 1.5% relative L2
BF16_LOSS_ATOL = 5e-3
BF16_GRAD_REL = 0.05

_JAX_CONFIG_MODULES = {"tinyllama-1.1b": "tinyllama_1_1b",
                       "gemma3-4b": "gemma3_4b"}


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX."""
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _arrays(jax, tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(vocab, b=2, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def jax_losses():
    """JAX's loss and gradients at SMOKE size, one jit compile for each
    (arch, attn_impl, dtype) asked for, kept for the module."""
    cache = {}

    def get(name, attn_impl, dtype="f32"):
        key = (name, attn_impl, dtype)
        if key not in cache:
            jax, jnp = _jax()
            import importlib
            from repro.models import transformer as jtf
            mod = importlib.import_module(
                f"repro.configs.{_JAX_CONFIG_MODULES[name]}")
            jcfg = dataclasses.replace(
                mod.SMOKE, attn_impl=attn_impl,
                dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
            params = jtf.lm_init_params(jax.random.key(0), jcfg)
            batch = {k: jnp.asarray(v) for k, v in _batch(256).items()}
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jtf.lm_train_forward(p, jcfg, batch)))(params)
            cache[key] = (float(loss), _arrays(jax, params),
                          _arrays(jax, grads))
        return cache[key]

    return get


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "gemma3-4b"])
def test_lm_loss_and_grads_match_jax(jax_losses, name, attn_impl, remat):
    """TinyLlama: one global run, an untied head. Gemma3: local and global
    runs (window 8 over 32 positions) and the tied head (embed.T through
    K6's plain version, its gradient summed into the embedding's)."""
    want_loss, params, want_grads = jax_losses(name, attn_impl)
    cfg = dataclasses.replace(LM_CONFIGS[name][1], attn_impl=attn_impl,
                              remat=remat)
    tparams = bridge.lm_params_from_arrays(params, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(256).items()}
    launches = (fa.flash_attention_fwd.launches, fce.fused_ce_fwd.launches)
    loss, grads = adamw.value_and_grad(
        lambda p, b: tf.lm_train_forward(p, cfg, b), tparams, batch)
    assert launches == (fa.flash_attention_fwd.launches,
                        fce.fused_ce_fwd.launches)     # CPU: plain routes
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), want_loss, rtol=F32_LOSS_RTOL)
    got = dict(keyed_leaves(grads))
    assert sorted(got) == sorted(want_grads)
    for key, g in got.items():
        want = want_grads[key]
        rel = np.linalg.norm(g.numpy() - want) / np.linalg.norm(want)
        assert rel <= F32_GRAD_REL, (key, rel)


def test_lm_loss_bf16_within_the_logits_rounding(jax_losses):
    name = "tinyllama-1.1b"
    want_loss, params, want_grads = jax_losses(name, "chunked", "bf16")
    cfg = dataclasses.replace(LM_CONFIGS[name][1], dtype=torch.bfloat16)
    tparams = bridge.lm_params_from_arrays(params, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(256).items()}
    loss, grads = adamw.value_and_grad(
        lambda p, b: tf.lm_train_forward(p, cfg, b), tparams, batch)
    assert abs(float(loss) - want_loss) <= BF16_LOSS_ATOL
    for key, g in keyed_leaves(grads):
        assert g.dtype == torch.bfloat16
        want = want_grads[key].astype(np.float32)
        rel = np.linalg.norm(g.float().numpy() - want) / np.linalg.norm(want)
        assert rel <= BF16_GRAD_REL, (key, rel)


def test_lm_loss_ragged_seq_and_masked_vocab():
    """S = 24 with seq_chunk 16 (the gcd fallback: chunks of 8) and a
    vocab of 200 padded to 256: the loss is the mean of ce_ref's
    per-token losses over the masked head."""
    cfg = dataclasses.replace(LM_CONFIGS["tinyllama-1.1b"][1], vocab=200)
    params = tf.lm_init_params(cfg, seed=1, device="cpu")
    b = _batch(200, s=24, seed=3)
    tokens, labels = (torch.from_numpy(b[k]) for k in ("tokens", "labels"))
    loss = tf.lm_loss(params, cfg, tokens, labels)
    with torch.no_grad():
        h = tf._final_hidden(cfg, params, tokens)[0]
        want = fce.ce_ref(h.reshape(-1, cfg.d_model), params["lm_head"],
                          labels.reshape(-1), cfg.vocab).mean()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)


def test_adamw_step_bit_equal_to_jax():
    """One adamw_update from the same parameters, gradients and moments
    (after a first JAX step, carried over by opt_state_from_arrays): the
    new parameters, moments and step are bit-equal, f32 and bf16 leaves,
    with and without clipping."""
    jax, jnp = _jax()
    from repro.optim import adamw as jad
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3)},
              "runs": [{"w": (2, 2, 3)}]}

    def tree(scale):
        return jax.tree.map(
            lambda s: jnp.asarray(
                (rng.standard_normal(s) * scale).astype(np.float32)),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    p0 = tree(1.0)
    p0["b"]["d"] = p0["b"]["d"].astype(jnp.bfloat16)
    g1, g2 = tree(1.0), tree(3.0)
    for clip in (None, 1.0):
        kw = dict(lr=1e-2, warmup_steps=3, total_steps=10, clip_norm=clip)
        jcfg = jad.AdamWConfig(**kw)
        p1, o1 = jad.adamw_update(g1, jad.init_opt_state(p0), p0, jcfg)
        p2, o2 = jad.adamw_update(g2, o1, p1, jcfg)
        tp1 = jax.tree.map(lambda a: bridge._tensor(np.asarray(a)), p1)
        to1 = bridge.opt_state_from_arrays(_arrays(jax, o1), tp1,
                                           device="cpu")
        tg2 = jax.tree.map(lambda a: bridge._tensor(np.asarray(a)), g2)
        tp2, to2 = adamw.adamw_update(tg2, to1, tp1,
                                      adamw.AdamWConfig(**kw))
        assert tp2 is tp1                                 # in place
        want = _arrays(jax, {"p": p2, "o": o2})
        got = keyed_leaves({"p": tp2, "o": to2})
        assert sorted(k for k, _ in got) == sorted(want)
        for key, t in got:
            w = want[key]
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                              w.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), w, err_msg=key)


def test_train_steps_match_jax():
    """Three steps of make_train_step (loss, gradient, clipped AdamW) at
    TinyLlama's SMOKE size against JAX's jitted make_train_step from the
    same parameters and batches: the losses agree at the f32 tolerance
    and the parameters within 1e-5, 1% of lr. Adam divides each gradient
    by its own running size, so where a gradient is near 0 its f32
    rounding (2e-6 relative over the leaf) picks the step's direction:
    one embedding weight in 16,384 moves 3.2e-6 apart here, the rest
    below 1e-6."""
    jax, jnp = _jax()
    from repro.configs.tinyllama_1_1b import SMOKE as JSMOKE
    from repro.models import transformer as jtf
    from repro.optim import adamw as jad
    cfg = LM_CONFIGS["tinyllama-1.1b"][1]
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    jp = jtf.lm_init_params(jax.random.key(3), JSMOKE)
    tp = bridge.lm_params_from_arrays(_arrays(jax, jp), cfg, device="cpu")
    jstep = jax.jit(jad.make_train_step(
        lambda p, b: jtf.lm_train_forward(p, JSMOKE, b),
        jad.AdamWConfig(**kw)))
    tstep = adamw.make_train_step(lambda p, b: tf.lm_train_forward(p, cfg, b),
                                  adamw.AdamWConfig(**kw))
    jo, to = jad.init_opt_state(jp), adamw.init_opt_state(tp)
    for i in range(3):
        b = _batch(256, seed=10 + i)
        jl, jp, jo = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tl, tp, to = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        np.testing.assert_allclose(float(tl), float(jl), rtol=F32_LOSS_RTOL)
    want = _arrays(jax, jp)
    for key, t in keyed_leaves(tp):
        np.testing.assert_allclose(t.detach().numpy(), want[key], rtol=0,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("warmup,total", [(3, 10), (100, 10_000), (0, 1)])
def test_schedule_matches_jax(warmup, total):
    """The learning rate through warmup, the cosine and past its end:
    bit-equal in f32."""
    jax, jnp = _jax()
    from repro.optim import adamw as jad
    jcfg = jad.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    tcfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    for step in sorted({0, 1, warmup // 2, warmup, warmup + 1,
                        (warmup + total) // 2, total, total + 7}):
        want = np.asarray(jad._schedule(jcfg, jnp.int32(step)))
        got = adamw._schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(step))


def test_clipping_and_global_norm():
    g = {"x": torch.full((4,), 3.0), "y": [torch.full((9,), 4.0 / 3.0)]}
    torch.testing.assert_close(adamw.global_norm(g), torch.tensor(7.2111025))
    params = {"x": torch.zeros(4), "y": [torch.zeros(9)]}
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=0, weight_decay=0.0,
                            clip_norm=1.0)
    _, opt = adamw.adamw_update(g, adamw.init_opt_state(params), params, cfg)
    # m = (1 - b1) * g * min(1, 1 / |g|): the clipped gradient's norm is 1
    torch.testing.assert_close(
        adamw.global_norm(opt["m"]) / (1 - cfg.beta1), torch.tensor(1.0))
    assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32


def test_int8_compression_bit_equal_to_jax():
    """compress_int8 (half-to-even ties, the 1e-12 scale floor) and three
    ef_compress_update steps: payloads, scales, decompressed gradients
    and residuals bit-equal."""
    jax, jnp = _jax()
    from repro.optim import compression as jco
    rng = np.random.default_rng(1)
    x = rng.standard_normal(64).astype(np.float32)
    x[:5] = [127.0, 2.5, -1.5, 0.5, 3.5]             # scale 1: exact ties
    qj, sj = jco.compress_int8(jnp.asarray(x))
    qt, st = compression.compress_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(qt.numpy()[:5], [127, 2, -2, 0, 4])
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    zero = compression.compress_int8(torch.zeros(3))
    assert not bool(zero[0].any()) and float(zero[1]) == np.float32(1e-12)

    params = {"w": np.zeros((6, 5), np.float32), "b": [np.zeros(3,
                                                                np.float32)]}
    js = jco.init_compression_state(jax.tree.map(jnp.asarray, params))
    ts = compression.init_compression_state(
        jax.tree.map(torch.from_numpy, params))
    for i in range(3):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        dj, js = jco.ef_compress_update(jax.tree.map(jnp.asarray, grads), js)
        dt, ts = compression.ef_compress_update(
            jax.tree.map(torch.from_numpy, grads), ts)
        want = _arrays(jax, {"dec": dj, "err": js.error})
        for key, t in keyed_leaves({"dec": dt, "err": ts.error}):
            np.testing.assert_array_equal(t.numpy(), want[key], err_msg=key)


def test_token_batches_deterministic_and_shifted(monkeypatch):
    a = list(lm_token_batches(3, 2, 50, 1000, n_steps=3, device="cpu"))
    b = list(lm_token_batches(3, 2, 50, 1000, n_steps=3, device="cpu"))
    assert len(a) == 3
    for x, y in zip(a, b):
        assert torch.equal(x["tokens"], y["tokens"])
        assert x["tokens"].shape == (2, 50) and x["tokens"].dtype == torch.long
        assert torch.equal(x["labels"][:, :-1], x["tokens"][:, 1:])
        assert int(x["tokens"].min()) >= 0 and int(x["tokens"].max()) < 1000
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])   # steps differ
    # a shard's stream depends on (seed, step, shard) only
    s1 = list(lm_token_batches(3, 2, 50, 1000, shard=1, n_steps=2,
                               device="cpu"))
    assert not torch.equal(s1[0]["tokens"], a[0]["tokens"])
    g = deterministic_shard(3, 1, 1)
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=deterministic_shard(3, 1, 1)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(lm_token_batches(0, 1, 4, 10))          # cuda unless told


def test_token_batches_follow_zipf():
    """The head of the Zipf(1.1) distribution: id 0's frequency within 5
    standard errors of its probability, and the ids' frequencies fall."""
    vocab, n = 32000, 4 * 4097
    (batch,) = lm_token_batches(0, 4, 4096, vocab, n_steps=1, device="cpu")
    toks = torch.cat([batch["tokens"], batch["labels"][:, -1:]], dim=1)
    ranks = np.arange(1, vocab + 1)
    p = (1.0 / ranks ** 1.1) / (1.0 / ranks ** 1.1).sum()
    counts = torch.bincount(toks.reshape(-1), minlength=vocab).numpy()
    assert counts.sum() == n
    assert abs(counts[0] / n - p[0]) <= 5 * np.sqrt(p[0] * (1 - p[0]) / n)
    assert counts[0] > counts[1] > counts[4] > counts[50]


def _state():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": torch.linspace(-3, 3, 7).to(torch.bfloat16),
            "opt": {"step": torch.tensor(5, dtype=torch.int32),
                    "m": [torch.ones(2, 3)]}}


def test_checkpoint_round_trip_and_keys(tmp_path):
    """Keys are JAX's keystr paths of the same tree; bf16 goes through its
    uint16 bits and comes back bit for bit; dtypes follow the template."""
    jax, jnp = _jax()
    from repro.runtime.checkpoint import _flatten as jflatten
    s = _state()
    path = save_checkpoint(str(tmp_path), 3, s)
    assert os.path.basename(path) == "ckpt_0000000003.npz"
    assert checkpoint_step(path) == 3
    with np.load(path) as d:
        keys = sorted(d.files)
        assert d["['h']"].dtype == np.uint16
    jtree = {"w": jnp.zeros((2, 3)), "h": jnp.zeros(7, jnp.bfloat16),
             "opt": {"step": jnp.int32(0), "m": [jnp.zeros((2, 3))]}}
    assert keys == sorted(jflatten(jtree))
    r = restore_checkpoint(latest_checkpoint(str(tmp_path)), s)
    for (k, a), (_, b) in zip(keyed_leaves(s), keyed_leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_restore_reads_a_jax_written_bf16_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote holds a bf16 leaf as numpy's
    two-byte void dtype (``|V2`` after ``np.load``); the port restores it
    into a bf16 template bit for bit, beside f32 and int leaves."""
    jax, jnp = _jax()
    from repro.runtime.checkpoint import save_checkpoint as jsave
    bits = np.arange(-300, 300, 7, dtype=np.int16).view(np.uint16)
    h = jnp.asarray(bits.view(np.int16)).view(jnp.bfloat16)
    jtree = {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3), "h": h,
             "opt": {"step": jnp.int32(5), "m": [jnp.ones((2, 3))]}}
    path = jsave(str(tmp_path), 4, jtree)
    with np.load(path) as d:
        assert d["['h']"].dtype.kind == "V" and d["['h']"].dtype.itemsize == 2
    r = restore_checkpoint(path, _state() | {"h": torch.zeros(
        bits.shape, dtype=torch.bfloat16)})
    assert r["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(r["h"].view(torch.int16).numpy()
                                  .view(np.uint16), bits)
    assert torch.equal(r["w"], torch.arange(6.0).reshape(2, 3))
    assert int(r["opt"]["step"]) == 5


def test_jax_restore_refuses_its_own_bf16_leaf(tmp_path):
    """The reference behaviour the port does not copy: JAX's own
    restore_checkpoint cannot read back the bf16 leaf it wrote."""
    jax, jnp = _jax()
    from repro.runtime import checkpoint as jck
    tree = {"w": jnp.ones(3, jnp.bfloat16)}
    path = jck.save_checkpoint(str(tmp_path), 0, tree)
    with pytest.raises((ValueError, TypeError)):
        jck.restore_checkpoint(path, tree)


def test_checkpoint_retention_mismatch_and_overlay(tmp_path):
    s = _state()
    for i in range(6):
        save_checkpoint(str(tmp_path), i, s, keep=2)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == ["ckpt_0000000004.npz", "ckpt_0000000005.npz"]
    bad = dict(s, w=torch.zeros(3, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(latest_checkpoint(str(tmp_path)), bad)
    delta = str(tmp_path / "delta")
    save_checkpoint(delta, 9, dict(s, w=torch.full((2, 3), 7.0)))
    r = restore_checkpoint(os.path.join(tmp_path, files[0]), s,
                           overlay=latest_checkpoint(delta))
    assert torch.equal(r["w"], torch.full((2, 3), 7.0))
    assert torch.equal(r["opt"]["m"][0], s["opt"]["m"][0])
    assert latest_checkpoint(str(tmp_path / "none")) is None


def _train_setup(steps):
    cfg = LM_CONFIGS["tinyllama-1.1b"][1]
    params = tf.lm_init_params(cfg, seed=0, device="cpu")
    batches = list(lm_token_batches(0, 2, 16, cfg.vocab, n_steps=steps,
                                    device="cpu"))
    step = adamw.make_train_step(
        lambda p, b: tf.lm_train_forward(p, cfg, b),
        adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps))

    def step_fn(state, i):
        _, p, o = step(state["params"], state["opt"], batches[i])
        return {"params": p, "opt": o}

    return {"params": params, "opt": adamw.init_opt_state(params)}, step_fn


def test_restart_replay_is_bit_exact(tmp_path):
    """Training with injected failures equals training without, bit for
    bit on the CPU (the deterministic pipeline and the restored state
    replay the same steps); the initial state is left as it was."""
    init, step_fn = _train_setup(6)
    before = {k: v.clone() for k, v in keyed_leaves(init)}
    clean = run_with_restarts(step_fn, init, 6, str(tmp_path / "a"),
                              ckpt_every=2)
    faulty = run_with_restarts(step_fn, init, 6, str(tmp_path / "b"),
                               ckpt_every=2,
                               injector=FailureInjector(fail_at=[1, 3, 5]))
    for (k, a), (_, b) in zip(keyed_leaves(clean), keyed_leaves(faulty)):
        assert torch.equal(a, b), k
    assert int(faulty["opt"]["step"]) == 6
    for k, v in keyed_leaves(init):
        assert torch.equal(v, before[k]), k


def test_restart_limit(tmp_path):
    def step_fn(state, step):
        return state

    with pytest.raises(RuntimeError, match="injected"):
        run_with_restarts(step_fn, {"w": torch.zeros(2)}, 10, str(tmp_path),
                          ckpt_every=100, max_restarts=3,
                          injector=FailureInjector(fail_at=range(100)))


def test_registry_names_the_ported_archs():
    """The dense and MoE LMs, the recsys archs and gin-tu resolve (each
    recsys CONFIG and gin-tu's JAX's value for value); nothing is left
    unported, and an unknown name raises."""
    for name in ("tinyllama-1.1b", "stablelm-1.6b", "gemma3-4b",
                 "granite-moe-1b-a400m", "olmoe-1b-7b"):
        assert config_module(name).SMOKE == LM_CONFIGS[name][1]
    jax, _ = _jax()
    import importlib
    from repro.configs.registry import ARCH_MODULES as JAX_ARCHS
    assert sorted(JAX_ARCHS) == sorted([*ARCH_MODULES, *NOT_PORTED])
    assert NOT_PORTED == ()
    for name in ("sasrec", "dien", "autoint", "two-tower-retrieval",
                 "gin-tu"):
        jcfg = importlib.import_module(JAX_ARCHS[name]).CONFIG
        jd = dataclasses.asdict(jcfg)
        td = dataclasses.asdict(config_module(name).CONFIG)
        assert np.dtype(jd.pop("dtype")).name == str(td.pop("dtype")).split(
            ".")[-1]
        assert jd == td, name
    tt = config_module("two-tower-retrieval")
    assert (tt.MPAD_DIM, tt.RERANK) == (64, 256)
    assert config_module("gin-tu").CONFIG.n_layers == 5
    with pytest.raises(KeyError, match="unknown arch"):
        config_module("gpt-5")


@pytest.mark.parametrize("compress", [False, True])
def test_train_launcher_runs_and_resumes(tmp_path, capsys, compress):
    from repro_torch.launch import train
    argv = ["--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    if compress:
        argv.append("--grad-compression")
    final = train.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "done; final step: 3" in out and out.count(" loss ") == 3
    assert int(final["opt"]["step"]) == 3
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 2
    again = train.main(argv, device="cpu")            # resumes at the end
    assert capsys.readouterr().out.count(" loss ") == 0
    for (k, a), (_, b) in zip(keyed_leaves(final), keyed_leaves(again)):
        assert torch.equal(a, b), k
    gin = train.main(["--arch", "gin-tu"], device="cpu")
    assert gin["ok"] and np.isfinite(gin["loss"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "olmoe-1b-7b"])
def test_train_launcher_trains_the_moe_smoke_lms(tmp_path, capsys, arch):
    """The MoE archs train their SMOKE config as the dense archs do: the
    dispatch combine, the router aux term, AdamW over the MoE leaves."""
    from repro_torch.launch import train
    final = train.main(["--arch", arch, "--steps", "3", "--batch", "2",
                        "--seq", "16", "--ckpt-dir", str(tmp_path)],
                       device="cpu")
    out = capsys.readouterr().out
    assert f"training reduced {LM_CONFIGS[arch][1].name}" in out
    assert "done; final step: 3" in out and out.count(" loss ") == 3
    leaves = dict(keyed_leaves(final["params"]))
    assert leaves["['runs'][0]['moe']['router']"].dtype == torch.float32
    assert all(bool(torch.isfinite(v).all()) for v in leaves.values())


@pytest.mark.parametrize("arch", ["sasrec", "dien", "autoint",
                                  "two-tower-retrieval"])
def test_train_launcher_runs_the_recsys_smoke(capsys, arch):
    """A recsys arch runs recsys_family.smoke(name), as JAX's launcher runs
    arch.smoke(): one AdamW step and one serve call, finite."""
    from repro_torch.launch import train
    out = train.main(["--arch", arch], device="cpu")
    assert out["ok"] and np.isfinite(out["loss"])
    assert "non-LM arch; smoke train step ran" in capsys.readouterr().out


def test_train_lm_example_survives_its_failure():
    """examples/train_lm_torch.py, the twin of examples/train_lm.py, on
    the CPU: the injected failure restarts from scratch (no checkpoint
    yet) and the loss falls."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "train_lm_torch.py")
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--steps", "8", "--batch", "2", "--seq", "32"],
                      device="cpu")
    assert len(losses) == 8 + 4 and losses[-1] < losses[0]
