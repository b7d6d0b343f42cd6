"""The LM serving rank programs over a ("data", "model") mesh against the
JAX package's sharded jit: ``parallel.step.make_sharded_prefill`` and
``make_sharded_decode_step`` on gloo ranks, and ``jax.jit(lm_prefill /
lm_decode_step, in_shardings=tree_named(mesh, ...), out_shardings=...)``
on 8 forced host devices, on the same parameters (JAX's
``lm_init_params(key(0))``, carried across with ``bridge``) and inputs
(numpy seeds).

The cases cover the five SMOKE configurations at meshes (1, 1), (2, 2) and
(4, 2) and every branch of ``lm_cache_specs``: the batch split over the
data axes with the sequence over "model", the batch whole with the
sequence over every axis, and window (local) caches whole. The SMOKE
caches are 64 slots, so their specs are ``lm_cache_specs``' branches
with its 8,192-slot threshold taken down (``_explicit_specs``); one case
decodes into an 8,192-slot seeded cache under ``lm_cache_specs`` itself.
A prompt shorter than the cache leaves the blocks past it empty during
the first decode steps: a rank whose block holds no visible slot (the
merge's trap). The MoE SMOKE configurations prefill on ``dispatch`` (the
whole batch's capacity) and one on ``ep`` (JAX's ``shard_map``); decode
runs the dense combine at model 2 (every expert gathered at use).

Tolerances: the logits within f32 atol 2e-4 (``tests/test_torch_lm.py``'s
bound: matmuls and softmax sums in other orders) and their argmax equal;
each rank's cache block has the shape of JAX's ``NamedSharding`` shard on
the device of the same index, its ``pos`` equal, its K / V within the same
2e-4, and the seeded slots no step writes bit-equal. At (1, 1) the rank
programs are bit-equal to ``lm_prefill`` / ``lm_decode_step``. Then the
merge's trap directly (``decode_attention`` with an empty block, against
one process and against a merge that subtracts each rank's own maximum)
and ``context.all_reduce_max`` with its collective counts.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import bridge  # noqa: E402
from repro_torch._tree import keyed_leaves  # noqa: E402
from repro_torch.configs import LM_CONFIGS, shape_config  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.context import Mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
# f32 on both sides, summed in other orders (tests/test_torch_lm.py)
ATOL = 2e-4
ARCHS = ("tinyllama-1.1b", "stablelm-1.6b", "gemma3-4b",
         "granite-moe-1b-a400m", "olmoe-1b-7b")
SLOTS, PROMPT, STEPS = 64, 20, 3
SEEDED_SLOTS, SEEDED_CUR = 8192, 3000

# case -> (arch, mesh, batch, specs, options). specs: "explicit" (the
# branches of lm_cache_specs on a 64-slot cache) or "own" (lm_cache_specs,
# an 8,192-slot seeded cache, decode only); vocab 250 pads the vocabulary
# to 256 (the masked tail in a logits block); impl "ep" prefills on EP
CASES = {
    **{f"{a}|1x1": (a, (1, 1), 2, "explicit", {}) for a in ARCHS},
    **{f"{a}|2x2|rows": (a, (2, 2), 4, "explicit", {}) for a in ARCHS},
    "tinyllama-1.1b|2x2|rows|vocab250": (
        "tinyllama-1.1b", (2, 2), 4, "explicit", {"vocab": 250}),
    "gemma3-4b|2x2|whole|vocab250": (
        "gemma3-4b", (2, 2), 1, "explicit", {"vocab": 250}),
    "granite-moe-1b-a400m|2x2|whole": (
        "granite-moe-1b-a400m", (2, 2), 1, "explicit", {}),
    "granite-moe-1b-a400m|2x2|rows|ep": (
        "granite-moe-1b-a400m", (2, 2), 4, "explicit", {"impl": "ep"}),
    "tinyllama-1.1b|4x2|rows": ("tinyllama-1.1b", (4, 2), 4, "explicit", {}),
    "olmoe-1b-7b|4x2|rows": ("olmoe-1b-7b", (4, 2), 4, "explicit", {}),
    "stablelm-1.6b|4x2|whole": ("stablelm-1.6b", (4, 2), 2, "explicit", {}),
    "gemma3-4b|4x2|whole": ("gemma3-4b", (4, 2), 2, "explicit", {}),
    "gemma3-4b|2x2|own-seeded": ("gemma3-4b", (2, 2), 2, "own", {}),
}
MESH_TAGS = ("1x1", "2x2", "4x2")
_JAX_MODULES = {"tinyllama-1.1b": "tinyllama_1_1b",
                "stablelm-1.6b": "stablelm_1_6b", "gemma3-4b": "gemma3_4b",
                "granite-moe-1b-a400m": "granite_moe_1b",
                "olmoe-1b-7b": "olmoe_1b_7b"}


def _tag(shape):
    return "x".join(map(str, shape))


def _with(cfg, opts):
    """A SMOKE config with a case's options applied (vocab, MoE impl)."""
    if "vocab" in opts:
        cfg = dataclasses.replace(cfg, vocab=opts["vocab"])
    if "impl" in opts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl=opts["impl"]))
    return cfg


def _port_cfg(case):
    arch, _, _, _, opts = CASES[case]
    return _with(LM_CONFIGS[arch][1], opts)


def _max_len(case):
    return SEEDED_SLOTS if CASES[case][3] == "own" else SLOTS


def _explicit_specs(runs, window, shape, batch):
    """``lm_cache_specs``' branches with its 8,192-slot threshold taken
    down, as spec entry tuples: the batch over the data axes when they
    divide it (the sequence over "model"), else whole (the sequence over
    every axis); a window (local) run's cache whole."""
    dp_size = int(np.prod(shape[:-1]))
    if batch % dp_size == 0 and batch >= dp_size:
        b_ax, seq = ("data",), ("model",)
    else:
        b_ax, seq = None, AXES
    out = []
    for kind in runs:
        local = kind == "local" and window
        out.append((None, b_ax, None if local else seq, None, None))
    return out


def _inputs(case, vocab):
    """(prompt tokens (B, PROMPT) or None, decode tokens (STEPS, B), the
    first decode position)."""
    _, _, batch, specs, _ = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    prompt = rng.integers(0, vocab, (batch, PROMPT)).astype(np.int32)
    steps = rng.integers(0, vocab, (STEPS, batch)).astype(np.int32)
    if specs == "own":
        return None, steps, SEEDED_CUR
    return prompt, steps, PROMPT


def _seeded_cache(runs, cfg, batch):
    """An 8,192-slot cache seeded with K / V and the positions of the
    first SEEDED_CUR tokens (a local run's ring holds the last window of
    them), as numpy arrays keyed like the cache tree."""
    rng = np.random.default_rng(11)
    out = []
    for kind, length in runs:
        local = kind == "local" and cfg.sliding_window
        s_run = min(cfg.sliding_window, SEEDED_SLOTS) if local \
            else SEEDED_SLOTS
        shape = (length, batch, s_run, cfg.n_kv_heads, cfg.d_head)
        pos = np.full((s_run,), -1, np.int32)
        written = np.arange(max(0, SEEDED_CUR - s_run), SEEDED_CUR)
        pos[written % s_run] = written
        out.append({"k": rng.standard_normal(shape).astype(np.float32),
                    "v": rng.standard_normal(shape).astype(np.float32),
                    "pos": pos})
    return out


# --- JAX's references, in a subprocess with 8 host devices -----------------

_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import dataclasses, importlib
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.models import transformer as tf
    from repro.parallel import sharding as sh
    from repro.parallel.context import mesh_context
    import test_torch_lm_serve_mesh as T

    out = {}

    def keyed(tree):
        return {jax.tree_util.keystr(p): l for p, l in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    def shards(prefix, tree, ids):
        for key, arr in keyed(tree).items():
            for s in arr.addressable_shards:
                r = ids.index(s.device.id)
                out[f"{prefix}|{key}|{r}"] = np.asarray(s.data)

    for case, (arch, shape, batch, specs, opts) in T.CASES.items():
        jmod = importlib.import_module("repro.configs." + T._JAX_MODULES[arch])
        cfg = T._with(jmod.SMOKE, opts)
        dec_cfg = cfg if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl="dense"))
        n = int(np.prod(shape))
        mesh = jax.make_mesh(shape, T.AXES, devices=jax.devices()[:n],
                             axis_types=(AxisType.Auto,) * 2)
        ids = [d.id for d in mesh.devices.flat]
        params = tf.lm_init_params(jax.random.key(0), cfg)
        pspec = sh.lm_param_specs(cfg)
        max_len = T._max_len(case)
        if specs == "own":
            cspec = sh.lm_cache_specs(cfg, mesh, batch, max_len)
            vals = T._seeded_cache(tf.layer_runs(cfg), cfg, batch)
            cache = [{k: jnp.asarray(v) for k, v in run.items()}
                     for run in vals]
        else:
            cspec = [{"k": P(*e), "v": P(*e), "pos": P(None)} for e in
                     T._explicit_specs([k for k, _ in tf.layer_runs(cfg)],
                                       cfg.sliding_window, shape, batch)]
            cache = tf.init_cache(cfg, batch, max_len)
        b_ax = cspec[0]["k"][1]
        prompt, steps, cur = T._inputs(case, cfg.vocab)
        named = lambda tree: sh.tree_named(mesh, tree)
        with mesh_context(mesh):
            cache = jax.device_put(cache, named(cspec))
            if prompt is not None:
                pre = jax.jit(lambda p, t, c: tf.lm_prefill(p, cfg, t, c),
                              in_shardings=named((pspec, P(b_ax, None),
                                                  cspec)),
                              out_shardings=named((P(b_ax, "model"), cspec)))
                logits, cache = pre(params, jnp.asarray(prompt), cache)
                out[f"logits|{case}|prefill"] = np.asarray(logits)
                shards(f"cache|{case}|prefill", cache, ids)
            dec = jax.jit(lambda p, t, n, c: tf.lm_decode_step(p, dec_cfg, t,
                                                               n, c),
                          in_shardings=named((pspec, P(b_ax), P(), cspec)),
                          out_shardings=named((P(b_ax, "model"), cspec)))
            for i in range(T.STEPS):
                logits, cache = dec(params, jnp.asarray(steps[i]),
                                    jnp.int32(cur + i), cache)
                out[f"logits|{case}|decode{i}"] = np.asarray(logits)
            shards(f"cache|{case}|decode", cache, ids)
    np.savez(sys.argv[1], **out)
    print("JAX_REFERENCE_OK")
""")


def _jax_params():
    """JAX's SMOKE parameters of every case's configuration, as keyed
    numpy arrays (the reference subprocess draws the same)."""
    import importlib

    import jax
    from repro.models import transformer as jtf
    out = {}
    for case, (arch, _, _, _, opts) in CASES.items():
        jmod = importlib.import_module(f"repro.configs.{_JAX_MODULES[arch]}")
        params = jtf.lm_init_params(jax.random.key(0), _with(jmod.SMOKE,
                                                             opts))
        out[case] = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
                     jax.tree_util.tree_flatten_with_path(params)[0]}
    return out


# --- the port's ranks -------------------------------------------------------

def _cache_specs(case, mesh, cfg):
    from repro_torch.models.transformer import layer_runs
    _, shape, batch, specs, _ = CASES[case]
    if specs == "own":
        return sh.lm_cache_specs(cfg, mesh, batch, _max_len(case))
    return [{"k": sh.P(*e), "v": sh.P(*e), "pos": sh.P(None)} for e in
            _explicit_specs([k for k, _ in layer_runs(cfg)],
                            cfg.sliding_window, shape, batch)]


def _full_cache(case, cfg):
    from repro_torch.models import transformer as tf
    batch = CASES[case][2]
    if CASES[case][3] == "own":
        vals = _seeded_cache(tf.layer_runs(cfg), cfg, batch)
        return [{k: torch.from_numpy(v) for k, v in run.items()}
                for run in vals]
    return tf.init_cache(cfg, batch, _max_len(case), device="cpu")


def _numpy(tree):
    return {k: v.numpy().copy() for k, v in keyed_leaves(tree)}


def serve_case(mesh, case, arrays):
    """One case on this rank: the prefill (if the case has a prompt) and
    STEPS decode steps through the rank programs, from the rank's blocks
    of JAX's parameters and of the case's cache; the logits blocks and
    cache blocks after each phase."""
    from repro_torch.parallel.step import (make_sharded_decode_step,
                                           make_sharded_prefill)
    cfg = dataclasses.replace(_port_cfg(case), attn_impl="flash")
    pspec = sh.lm_param_specs(cfg)
    cspec = _cache_specs(case, mesh, cfg)
    b_ax = cspec[0]["k"][1]
    params = sh.shard_tree(mesh, bridge.lm_params_from_arrays(
        arrays, cfg, "cpu"), pspec)
    cache = sh.shard_tree(mesh, _full_cache(case, cfg), cspec)
    prompt, steps, cur = _inputs(case, cfg.vocab)
    got = {}
    if prompt is not None:
        prefill = make_sharded_prefill(cfg, mesh, pspec, cspec)
        toks = sh.rank_block(mesh, torch.from_numpy(prompt).long(),
                             sh.P(b_ax, None))
        logits, cache = prefill(params, toks, cache)
        got["logits|prefill"] = logits.numpy().copy()
        got["cache|prefill"] = _numpy(cache)
    decode = make_sharded_decode_step(shape_config(cfg, "decode"), mesh,
                                      pspec, cspec)
    for i in range(STEPS):
        tok = sh.rank_block(mesh, torch.from_numpy(steps[i]).long(),
                            sh.P(b_ax))
        logits, cache = decode(params, tok, torch.tensor(cur + i,
                                                         dtype=torch.int32),
                               cache)
        got[f"logits|decode{i}"] = logits.numpy().copy()
    got["cache|decode"] = _numpy(cache)
    return got


def _trap_check(mesh):
    """``decode_attention`` on a (1, 2) mesh whose rank 1 holds no visible
    slot, against one process's ``chunked_attention`` over the whole
    cache; and the merge that subtracts each rank's own maximum and
    weighs the normalised outputs by their sums."""
    from repro_torch.models.layers import chunked_attention
    from repro_torch.parallel import context as ctx
    from repro_torch.parallel.step import decode_attention
    g = torch.Generator().manual_seed(5)
    b, s, h, kv, dh = 2, 16, 4, 2, 8
    q = torch.randn(b, 1, h, dh, generator=g)
    k = torch.randn(b, s, kv, dh, generator=g)
    v = torch.randn(b, s, kv, dh, generator=g)
    pos = torch.full((s,), -1, dtype=torch.int32)
    pos[:5] = torch.arange(5, dtype=torch.int32)          # slots 0..4 only
    q_pos = torch.tensor([4], dtype=torch.int32)
    want = chunked_attention(q, k, v, q_pos, pos, kv_chunk=s)
    m = mesh.axis_index("model")
    blk = slice(m * s // 2, (m + 1) * s // 2)
    got = decode_attention(mesh, ("model",), q, k[:, blk], v[:, blk], q_pos,
                           pos[blk], None)
    local = chunked_attention(q, k[:, blk], v[:, blk], q_pos, pos[blk],
                              kv_chunk=s // 2)
    # the local merge: each rank's softmax normalised alone, weighed by
    # its sum of exp(s - local max) (an empty block sums s // 2 ones)
    qg = q.reshape(b, 1, kv, h // kv, dh).float()
    sc = torch.einsum("bqkgd,bckd->bqkgc", qg, k[:, blk].float()) / dh ** 0.5
    ok = (pos[blk] >= 0) & (pos[blk] <= 4)
    sc = sc.masked_fill(~ok, -1e30)
    l_loc = torch.exp(sc - sc.amax(-1, keepdim=True)).sum(-1)
    l_loc = l_loc.reshape(b, 1, h)[..., None]
    naive = ctx.all_reduce_sum(mesh, local * l_loc, "model") / \
        ctx.all_reduce_sum(mesh, l_loc, "model")
    return {"err": float((got - want).abs().max()),
            "naive_err": float((naive - want).abs().max())}


def _collective_check(mesh):
    """``all_reduce_max`` over "model", over "data" and over both, with
    ``count_collectives``' readings."""
    from repro_torch.parallel import context as ctx
    x = torch.tensor([float(mesh.rank), -float(mesh.rank), 3.0])
    out = {}
    for axes in ("model", "data", AXES):
        with ctx.count_collectives() as c:
            got = ctx.all_reduce_max(mesh, x, axes)
        out[str(axes)] = (got.tolist(), dict(c.bytes), dict(c.calls))
    return out


def rank_cases(mesh, tag, arrays):
    """Every case of mesh ``tag`` on this rank, then (at (2, 2)) the
    collective and trap checks; every rank's readings to rank 0."""
    import torch.distributed as dist
    got = {case: serve_case(mesh, case, arrays[case]) for case in CASES
           if _tag(CASES[case][1]) == tag}
    if tag == "2x2":
        got["collectives"] = _collective_check(mesh)
    every = [None] * mesh.size
    dist.all_gather_object(every, got)
    return every


@pytest.fixture(scope="module")
def runs():
    """JAX's references (a subprocess) and every rank's readings, side by
    side."""
    from repro_torch.launch.mesh import run_ranks
    arrays = _jax_params()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.Popen([sys.executable, "-c", _SCRIPT, ref_path],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            got = {tag: run_ranks(rank_cases, tuple(map(int, tag.split("x"))),
                                  (tag, arrays), device="cpu", axis=AXES)
                   for tag in MESH_TAGS}
            got["trap"] = run_ranks(_trap_rank, (1, 2), (), device="cpu",
                                    axis=AXES)
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert "JAX_REFERENCE_OK" in stdout, stderr[-3000:]
        with np.load(ref_path) as f:
            ref = {k: f[k] for k in f.files}
    return ref, got, arrays


def _trap_rank(mesh):
    import torch.distributed as dist
    every = [None] * mesh.size
    dist.all_gather_object(every, _trap_check(mesh))
    return every


def _record(tag, rank):
    shape = tuple(map(int, tag.split("x")))
    return Mesh(axis="data", size=int(np.prod(shape)), rank=rank, group=None,
                backend="gloo", device=torch.device("cpu"), names=AXES,
                dims=shape)


def _phases(case):
    return ((["prefill"] if CASES[case][3] != "own" else [])
            + [f"decode{i}" for i in range(STEPS)])


# --- against JAX --------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_logits_blocks_match_jax(runs, case):
    """Each rank's vocabulary block of each phase's logits (its batch rows)
    within ATOL of JAX's sharded jit's, the padded tail masked; the
    blocks put together give JAX's argmax."""
    ref, got, _ = runs
    tag = _tag(CASES[case][1])
    cfg = _port_cfg(case)
    cspec = _cache_specs(case, _record(tag, 0), cfg)
    b_ax = cspec[0]["k"][1]
    for phase in _phases(case):
        want = ref[f"logits|{case}|{phase}"]
        blocks = []
        for r, every in enumerate(got[tag]):
            rec = _record(tag, r)
            block = every[case][f"logits|{phase}"]
            want_block = sh.rank_block(rec, torch.from_numpy(want),
                                       sh.P(b_ax, "model")).numpy()
            np.testing.assert_allclose(block, want_block, rtol=0, atol=ATOL,
                                       err_msg=f"{phase} rank {r}")
            blocks.append(torch.from_numpy(block))
        full = _assemble(tag, sh.P(b_ax, "model"), blocks)
        assert float(full[:, cfg.vocab:].max(initial=-np.inf)) <= -1e29 \
            or cfg.vocab == cfg.vocab_padded
        np.testing.assert_array_equal(
            np.argmax(full[:, :cfg.vocab], -1),
            np.argmax(want[:, :cfg.vocab], -1), err_msg=phase)


def _assemble(tag, spec, blocks):
    """The full array from every rank's block (ranks that hold the same
    block hold the same bits)."""
    rec = _record(tag, 0)
    split = [(d, e) for d, e in enumerate(spec) if e is not None]
    shape = list(blocks[0].shape)
    for dim, axes in split:
        shape[dim] *= rec.axis_size(axes)
    full = np.full(shape, np.nan, np.float32)
    for r, blk in enumerate(blocks):
        at = _record(tag, r)
        index = [slice(None)] * len(shape)
        for dim, axes in split:
            per = blk.shape[dim]
            index[dim] = slice(at.axis_index(axes) * per,
                               (at.axis_index(axes) + 1) * per)
        prev = full[tuple(index)]
        if not np.isnan(prev).all():
            np.testing.assert_array_equal(prev, blk.numpy())
        full[tuple(index)] = blk.numpy()
    assert not np.isnan(full).any()
    return full


@pytest.mark.parametrize("case", list(CASES))
def test_cache_blocks_match_jax_shards(runs, case):
    """After the prefill and after the decode steps, rank r's block of
    every cache leaf has the shape of JAX's shard on device r; ``pos``
    equal, K / V within ATOL; in the seeded case the slots no step wrote
    keep their seeded bits on both sides."""
    ref, got, _ = runs
    tag = _tag(CASES[case][1])
    phases = (["prefill"] if CASES[case][3] != "own" else []) + ["decode"]
    cfg = _port_cfg(case)
    for phase in phases:
        for r, every in enumerate(got[tag]):
            blocks = every[case][f"cache|{phase}"]
            for key, block in blocks.items():
                want = ref[f"cache|{case}|{phase}|{key}|{r}"]
                assert block.shape == want.shape, (phase, key, r)
                if key.endswith("['pos']"):
                    np.testing.assert_array_equal(block, want)
                else:
                    np.testing.assert_allclose(block, want, rtol=0,
                                               atol=ATOL,
                                               err_msg=f"{phase} {key} {r}")
    if CASES[case][3] == "own":
        from repro_torch.models.transformer import layer_runs
        seeded = _seeded_cache(layer_runs(cfg), cfg, CASES[case][2])
        for r, every in enumerate(got[tag]):
            rec = _record(tag, r)
            cspec = _cache_specs(case, rec, cfg)
            blocks = every[case]["cache|decode"]
            for i, run in enumerate(seeded):
                s_run = run["pos"].shape[0]
                written = (SEEDED_CUR + np.arange(STEPS)) % s_run
                for leaf in ("k", "v"):
                    start = sh.rank_block(rec, torch.from_numpy(run[leaf]),
                                          cspec[i][leaf]).numpy()
                    block = blocks[f"[{i}]['{leaf}']"]
                    want = ref[f"cache|{case}|decode|[{i}]['{leaf}']|{r}"]
                    lo = (rec.axis_index(cspec[i][leaf][2])
                          * block.shape[2] if cspec[i][leaf][2] else 0)
                    kept = np.ones(block.shape[2], bool)
                    mine = written - lo
                    kept[mine[(mine >= 0) & (mine < block.shape[2])]] = False
                    np.testing.assert_array_equal(block[:, :, kept],
                                                  start[:, :, kept])
                    np.testing.assert_array_equal(want[:, :, kept],
                                                  start[:, :, kept])


# --- one rank: the one-process operations -----------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_is_lm_prefill_and_decode_bit_for_bit(arch):
    """At (1, 1) (no collective, no process group) the rank programs run
    ``lm_prefill`` / ``lm_decode_step``'s operations: logits and every
    cache leaf bit-equal after the prefill and each decode step, on K5's
    route (``attn_impl="flash"``; its plain version here) with a 64-slot
    cache (gemma3's 8-slot rings wrap)."""
    from repro_torch.models import transformer as tf
    from repro_torch.parallel.step import (make_sharded_decode_step,
                                           make_sharded_prefill)
    mesh = _record("1x1", 0)
    cfg = dataclasses.replace(LM_CONFIGS[arch][1], attn_impl="flash")
    params = tf.lm_init_params(cfg, 0, device="cpu")
    pspec = sh.lm_param_specs(cfg)
    cspec = sh.lm_cache_specs(cfg, mesh, 2, SLOTS)
    prompt, steps, cur = _inputs(f"{arch}|1x1", cfg.vocab)
    a = tf.init_cache(cfg, 2, SLOTS, device="cpu")
    b = tf.init_cache(cfg, 2, SLOTS, device="cpu")
    la, a = make_sharded_prefill(cfg, mesh, pspec, cspec)(
        sh.shard_tree(mesh, params, pspec), torch.from_numpy(prompt).long(),
        a)
    lb, b = tf.lm_prefill(params, cfg, torch.from_numpy(prompt).long(), b)
    assert torch.equal(la, lb)
    dc = shape_config(cfg, "decode")
    dec = make_sharded_decode_step(dc, mesh, pspec, cspec)
    for i in range(STEPS):
        t = torch.from_numpy(steps[i]).long()
        la, a = dec(params, t, torch.tensor(cur + i, dtype=torch.int32), a)
        lb, b = tf.lm_decode_step(params, dc, t, cur + i, b)
        assert torch.equal(la, lb), i
    for (key, x), (_, y) in zip(keyed_leaves(a), keyed_leaves(b)):
        assert torch.equal(x, y), key


def test_decode_refuses_a_position_past_the_cache():
    """A position past a full (global) cache fails in the index write, as
    ``lm_decode_step`` refuses it; the cache's last slot is taken."""
    from repro_torch.models import transformer as tf
    from repro_torch.parallel.step import make_sharded_decode_step
    mesh = _record("1x1", 0)
    cfg = LM_CONFIGS["tinyllama-1.1b"][1]
    pspec = sh.lm_param_specs(cfg)
    dec = make_sharded_decode_step(cfg, mesh, pspec,
                                   sh.lm_cache_specs(cfg, mesh, 1, 8))
    params = tf.lm_init_params(cfg, 0, "cpu")
    cache = tf.init_cache(cfg, 1, 8, device="cpu")
    tok = torch.zeros(1, dtype=torch.long)
    logits, cache = dec(params, tok, torch.tensor(7), cache)
    assert cache[0]["pos"].tolist() == [-1] * 7 + [7]
    with pytest.raises((IndexError, RuntimeError)):
        dec(params, tok, torch.tensor(8), cache)
    with pytest.raises(ValueError, match="past the cache"):
        tf.lm_decode_step(params, cfg, tok, 8, cache)


# --- the traps ----------------------------------------------------------------

def test_empty_block_adds_nothing_to_the_merge(runs):
    """A rank whose block holds no visible slot: the merged attention is
    one process's within f32 rounding on both ranks, where a merge over
    each rank's own maximum adds the empty block's values (every masked
    slot weighs exp(0) = 1 there)."""
    for r, rec in enumerate(runs[1]["trap"]):
        assert rec["err"] < 1e-6, (r, rec)
        assert rec["naive_err"] > 1e-2, (r, rec)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "olmoe-1b-7b"])
def test_dense_moe_decode_reads_every_expert(runs, arch):
    """Decode runs the dense combine, which combines the experts it is
    given: at model 2 the rank programs gather every expert at use
    (``moe_blocks`` is false for it), and the decode logits at (2, 2)
    match JAX's (each model rank holds half the experts' blocks)."""
    from repro_torch.parallel.step import _use_specs, moe_blocks
    cfg = LM_CONFIGS[arch][1]
    assert not moe_blocks(shape_config(cfg, "decode"))
    assert moe_blocks(cfg) and moe_blocks(dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl="ep")))
    pspec = sh.lm_param_specs(cfg)
    # gathered at use: the MoE leaves keep their "model" entries
    assert _use_specs(pspec, False)["runs"][0]["moe"]["w_up"] == \
        sh.P(None, "model", None, None)
    assert _use_specs(pspec, True)["runs"][0]["moe"]["w_up"] == sh.P()
    ref, got, _ = runs
    case = f"{arch}|2x2|rows"
    for r, every in enumerate(got["2x2"]):
        rec = _record("2x2", r)
        for i in range(STEPS):
            want = sh.rank_block(rec, torch.from_numpy(
                ref[f"logits|{case}|decode{i}"]), sh.P("data", "model"))
            np.testing.assert_allclose(every[case][f"logits|decode{i}"],
                                       want.numpy(), rtol=0, atol=ATOL)


# --- all_reduce_max -----------------------------------------------------------

def test_all_reduce_max_is_pmax_and_counted(runs):
    """``lax.pmax`` over "model", "data" and both, on every rank of a
    (2, 2) mesh (rank = 2 d + m), each call counted as one all-reduce of
    its operand's bytes a group it runs on."""
    for r, every in enumerate(runs[1]["2x2"]):
        got = every["collectives"]
        d, m = divmod(r, 2)
        model = [2 * d + 1, -2 * d, 3.0]
        data = [2 + m, -m, 3.0]
        both = [3.0, 0.0, 3.0]
        for axes, want, calls in (("model", model, 1), ("data", data, 1),
                                  (str(AXES), both, 1)):
            vals, nbytes, ncalls = got[axes]
            assert vals == [float(x) for x in want], (r, axes)
            assert ncalls["all-reduce"] == calls and nbytes[
                "all-reduce"] == 12 * calls, (r, axes)
            assert sum(ncalls.values()) == calls


def test_merge_axes_are_the_cache_specs_split_axes():
    """The decode merge runs over the axes of size > 1 that a run's cache
    spec splits the sequence on, and over none (no collective) where the
    spec splits nothing or only size-1 axes."""
    from repro_torch.parallel.step import _seq_axes
    rec = _record("4x2", 0)
    assert _seq_axes(rec, {"k": sh.P(None, "data", "model", None, None)}) \
        == ("model",)
    assert _seq_axes(rec, {"k": sh.P(None, None, ("data", "model"), None,
                                     None)}) == AXES
    assert _seq_axes(rec, {"k": sh.P(None, "data", None, None, None)}) == ()
    one = _record("1x1", 0)
    assert _seq_axes(one, {"k": sh.P(None, None, ("data", "model"), None,
                                     None)}) == ()


def test_explicit_specs_are_lm_cache_specs_branches():
    """The explicit specs follow ``lm_cache_specs`` at and above its
    8,192-slot threshold, for each branch (every SMOKE config, every
    mesh, batch split or not)."""
    from repro_torch.models.transformer import layer_runs
    for arch in ARCHS:
        cfg = LM_CONFIGS[arch][0]
        for tag in MESH_TAGS:
            rec = _record(tag, 0)
            for batch in (1, 2, 4, 8):
                got = _explicit_specs([k for k, _ in layer_runs(cfg)],
                                      cfg.sliding_window, rec.dims, batch)
                want = sh.lm_cache_specs(cfg, rec, batch, 8192 * 8)
                assert [sh.P(*e) for e in got] == [w["k"] for w in want], \
                    (arch, tag, batch)


def test_prefill_writes_only_the_block_it_holds():
    """``_prefill_writes``: the whole cache's (positions, slots), and the
    block's share of them in local slots, ring writes included."""
    from repro_torch.parallel.step import _prefill_writes
    src, dst, sm, dm = _prefill_writes(20, 8, 4, 4, "cpu")
    assert src.tolist() == list(range(12, 20))
    assert dst.tolist() == [p % 8 for p in range(12, 20)]
    assert sm.tolist() == [12, 13, 14, 15] and dm.tolist() == [0, 1, 2, 3]
    src, dst, sm, dm = _prefill_writes(5, 16, 8, 8, "cpu")
    assert sm.numel() == 0 and dm.numel() == 0
    whole = _prefill_writes(5, 16, 0, 16, "cpu")
    assert whole[2] is whole[0] and whole[3] is whole[1]
