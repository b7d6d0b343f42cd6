"""The model side's sharding of the port against the JAX package's: the
spec sets (``lm_param_specs``, ``opt_specs``, ``zero_opt_specs``,
``lm_cache_specs``, GIN's and the four recommenders') entry for entry at
meshes (1, 1), (2, 2), (4, 2) and (2, 2, 2); ``rank_block`` on granite
SMOKE's parameters, its ZeRO-1 opt state and two KV caches bit for bit
against the shards JAX's ``NamedSharding`` places on 8 forced host
devices (and put back together from them); and the sharded train step over
gloo ranks against ``jax.jit(make_train_step's body, in_shardings=...,
out_shardings=...)`` after two steps (granite SMOKE with ``impl="ep"``,
cf 1.25, at (2, 2), (1, 2) and (2, 1); tinyllama SMOKE at (2, 2)): loss,
every parameter, every rank's gradient blocks. At (1, 1) the sharded step
is bit-equal to the port's ``make_train_step``.

JAX's references come from one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and an
``AxisType.Auto`` mesh (this process keeps one device); the gloo ranks
run beside it, spawned once a mesh shape. Both sides draw the same
inputs: JAX's ``lm_init_params(key(0))`` and numpy seeds.
"""
import dataclasses
import importlib
import os
import subprocess
import sys
import tempfile
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import bridge  # noqa: E402
from repro_torch._tree import keyed_leaves  # noqa: E402
from repro_torch.configs import LM_CONFIGS  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.context import Mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
BLOCK_MESHES = ("2x2", "4x2", "2x2x2")
BLOCK_TREES = ("params", "opt", "cache_a", "cache_b")
CACHES = {"cache_a": (2, 8192), "cache_b": (1, 8192)}
STEP_CASES = (("granite", "2x2"), ("granite", "1x2"), ("granite", "2x1"),
              ("tinyllama", "2x2"))
BATCH, SEQ = 4, 32
# Adam's eps at 1e-6, not the default 1e-8: a step moves an element by lr
# * g / (|g| + eps), which turns on a gradient's last bits where |g| is
# near eps. Both packages form the gradients in f32 in different orders
# (~1e-8 apart where terms of 1e-4 cancel), and with eps 1e-8 one element
# of granite's (2, 1) run (|g| 1.6e-8 against a typical 1e-2) moved
# 2.2e-5. At 1e-6 such noise moves no parameter past 2e-5, while a wrong
# gradient (or step) still moves one by ~lr: 2e-4 at step 1
ADAM = dict(lr=1e-3, warmup_steps=5, total_steps=10, eps=1e-6)
# and one case at the configuration's own eps (AdamWConfig's default,
# 1e-8), held to PARAM_ATOL_DEFAULT_EPS: the element above reads 2.2e-5
# there (the worst of all parameters), while a wrong update (one data
# block left out of the ZeRO all-gather) reads 6.4e-4
DEFAULT_EPS_CASES = (("granite", "2x1"),)
STEP_RUNS = STEP_CASES + tuple((f"{k}:eps-default", t)
                               for k, t in DEFAULT_EPS_CASES)
# f32 on both sides: the same operations, summed in other orders
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
PARAM_ATOL_DEFAULT_EPS = 1e-4
GRAD_REL = 1e-5
_JAX_MODULES = {"tinyllama-1.1b": "tinyllama_1_1b",
                "stablelm-1.6b": "stablelm_1_6b", "gemma3-4b": "gemma3_4b",
                "granite-moe-1b-a400m": "granite_moe_1b",
                "olmoe-1b-7b": "olmoe_1b_7b"}
_FAMILY = {"gin": ("gin_tu", "gnn", "gin_init_params"),
           "sasrec": ("sasrec", "recsys", "sasrec_init"),
           "dien": ("dien", "recsys", "dien_init"),
           "autoint": ("autoint", "recsys", "autoint_init"),
           "twotower": ("two_tower_retrieval", "recsys", "twotower_init")}


def _mesh_ns(tag):
    shape, axes = MESHES[tag] if tag in MESHES else (
        tuple(int(n) for n in tag.split("x")), ("data", "model"))
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _mesh_record(tag, rank):
    """A rank's N-D mesh record; laying blocks out needs no group."""
    shape, axes = (MESHES[tag] if tag in MESHES else
                   (tuple(int(n) for n in tag.split("x")),
                    ("data", "model")))
    return Mesh(axis=axes[0], size=int(np.prod(shape)), rank=rank,
                group=None, backend="gloo", device=torch.device("cpu"),
                names=axes, dims=shape)


def _adam(kind):
    """AdamWConfig's arguments for a step run: ADAM, or ADAM at the
    default eps for a ``:eps-default`` run."""
    if kind.endswith(":eps-default"):
        return {k: v for k, v in ADAM.items() if k != "eps"}
    return ADAM


def _port_cfg(kind):
    """granite SMOKE with impl="ep" at cf 1.25, or tinyllama SMOKE."""
    name = {"granite": "granite-moe-1b-a400m",
            "tinyllama": "tinyllama-1.1b"}[kind.split(":")[0]]
    cfg = LM_CONFIGS[name][1]
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="ep", capacity_factor=1.25))
    return cfg


def _batches(vocab):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        t = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _block_values(name, shapes):
    """Seeded values for the opt state / cache trees, keyed by path."""
    rng = np.random.default_rng(sum(map(ord, name)))
    return {k: (rng.integers(-5, 100, shape).astype(np.int32)
                if dt == "int32" else
                rng.standard_normal(shape).astype(np.float32))
            for k, (shape, dt) in shapes.items()}


# --- JAX's references, in a subprocess with 8 host devices -----------------

_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.models import transformer as tf
    from repro.optim import AdamWConfig, adamw_update, init_opt_state
    from repro.parallel import sharding as sh
    from repro.parallel.context import mesh_context
    import test_torch_model_sharding as T

    out_path = sys.argv[1]
    out = {}

    def keyed(tree):
        return {jax.tree_util.keystr(p): l for p, l in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    def mesh_of(tag):
        shape, axes = (T.MESHES[tag] if tag in T.MESHES else
                       (tuple(int(n) for n in tag.split("x")),
                        ("data", "model")))
        n = int(np.prod(shape))
        return jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                             axis_types=(AxisType.Auto,) * len(axes))

    def jcfg(kind):
        from repro.configs import granite_moe_1b, tinyllama_1_1b
        if kind.split(":")[0] == "tinyllama":
            return tinyllama_1_1b.SMOKE
        c = granite_moe_1b.SMOKE
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, impl="ep", capacity_factor=1.25))

    # 1. NamedSharding's shards of granite SMOKE's trees
    cfg = jcfg("granite")
    params = tf.lm_init_params(jax.random.key(0), cfg)
    for tag in T.BLOCK_MESHES:
        mesh = mesh_of(tag)
        ids = [d.id for d in mesh.devices.flat]
        out[f"ids|{tag}"] = np.asarray(ids)
        pspec = sh.lm_param_specs(cfg)
        trees = {"params": (params, pspec)}
        ospec = sh.zero_opt_specs(params, pspec, mesh)
        opt0 = init_opt_state(params)
        vals = T._block_values("opt", {k: (v.shape, str(v.dtype))
                                       for k, v in keyed(opt0).items()})
        opt = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(opt0),
            [jnp.asarray(vals[k]) for k in keyed(opt0)])
        trees["opt"] = (opt, ospec)
        for name, (b, s) in T.CACHES.items():
            c0 = tf.init_cache(cfg, b, s, jnp.float32)
            vals = T._block_values(name, {k: (v.shape, str(v.dtype))
                                          for k, v in keyed(c0).items()})
            cache = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(c0),
                [jnp.asarray(vals[k]) for k in keyed(c0)])
            trees[name] = (cache, sh.lm_cache_specs(cfg, mesh, b, s))
        for name, (tree, spec) in trees.items():
            placed = jax.device_put(tree, sh.tree_named(mesh, spec))
            for key, arr in keyed(placed).items():
                for shard in arr.addressable_shards:
                    r = ids.index(shard.device.id)
                    out[f"block|{tag}|{name}|{key}|{r}"] = np.asarray(
                        shard.data)

    # 2. the sharded train step, two steps, and step 0's gradient
    for kind, tag in T.STEP_RUNS:
        adam = AdamWConfig(**T._adam(kind))
        cfg = jcfg(kind)
        mesh = mesh_of(tag)
        params = tf.lm_init_params(jax.random.key(0), cfg)
        pspec = sh.lm_param_specs(cfg)
        ospec = sh.zero_opt_specs(params, pspec, mesh)
        bspec = {"tokens": P(("data",), None), "labels": P(("data",), None)}

        def step(p, o, b):
            # make_train_step's body, with the gradient returned too
            loss, grads = jax.value_and_grad(
                lambda q: tf.lm_train_forward(q, cfg, b))(p)
            p, o = adamw_update(grads, o, p, adam)
            return loss, grads, p, o

        with mesh_context(mesh):
            jstep = jax.jit(step, in_shardings=sh.tree_named(
                mesh, (pspec, ospec, bspec)), out_shardings=sh.tree_named(
                mesh, (P(), pspec, pspec, ospec)))
            opt = init_opt_state(params)
            losses = []
            for i, b in enumerate(T._batches(cfg.vocab)):
                b = {k: jnp.asarray(v) for k, v in b.items()}
                loss, grads, params, opt = jstep(params, opt, b)
                losses.append(float(loss))
                if i == 0:
                    for key, g in keyed(grads).items():
                        out[f"grad|{kind}|{tag}|{key}"] = np.asarray(g)
        out[f"loss|{kind}|{tag}"] = np.asarray(losses)
        for key, p in keyed(params).items():
            out[f"param|{kind}|{tag}|{key}"] = np.asarray(p)
    np.savez(out_path, **out)
    print("JAX_REFERENCE_OK")
""")


def _jax_arrays(tree):
    import jax
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_params(kind):
    """JAX's initial parameters and AdamW state of the model, as keyed
    numpy arrays."""
    import jax
    from repro.models import transformer as jtf
    from repro.configs import granite_moe_1b, tinyllama_1_1b
    from repro.optim import init_opt_state
    cfg = (tinyllama_1_1b.SMOKE if kind == "tinyllama"
           else granite_moe_1b.SMOKE)
    params = jtf.lm_init_params(jax.random.key(0), cfg)
    return {"params": _jax_arrays(params),
            "opt": _jax_arrays(init_opt_state(params))}


# --- the port's ranks -------------------------------------------------------

def rank_steps(mesh, cases, arrays):
    """One gloo rank: for each model, two sharded steps from JAX's
    parameters and AdamW state carried into the rank's blocks
    (``sh.shard_tree``; step 0's gradient blocks taken
    first), the full parameters gathered after them, and every rank's
    gradient blocks (gathered to every rank as objects)."""
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.models import transformer as tf
    from repro_torch.parallel.step import (lm_batch_specs,
                                           make_sharded_train_step,
                                           sharded_value_and_grad)
    out = {}
    for kind in cases:
        cfg = _port_cfg(kind)
        template = tf.lm_init_params(cfg, 0, device="cpu")
        pspec = sh.lm_param_specs(cfg)
        ospec = sh.zero_opt_specs(template, pspec, mesh)
        params = sh.shard_tree(mesh, bridge.params_from_arrays(
            arrays[kind.split(":")[0]]["params"], template, "cpu"), pspec)
        opt = sh.shard_tree(mesh, bridge.params_from_arrays(
            arrays[kind.split(":")[0]]["opt"], optim.init_opt_state(template),
            "cpu"),
            ospec)
        step = make_sharded_train_step(cfg, optim.AdamWConfig(**_adam(kind)),
                                       mesh, pspec, ospec)
        bspec = lm_batch_specs(mesh)
        losses, grads0 = [], None
        for i, b in enumerate(_batches(cfg.vocab)):
            b = sh.shard_tree(mesh, {k: torch.from_numpy(v).long()
                                     for k, v in b.items()}, bspec)
            if i == 0:
                _, g = sharded_value_and_grad(cfg, mesh, pspec, params, b)
                grads0 = {k: v.detach().numpy() for k, v in keyed_leaves(g)}
            loss, params, opt = step(params, opt, b)
            losses.append(float(loss))
        every = [None] * mesh.size
        dist.all_gather_object(every, grads0)
        full = sh.gather_tree(mesh, params, pspec)
        out[kind] = {"loss": losses, "grads": every,
                     "params": {k: v.detach().float().numpy()
                                for k, v in keyed_leaves(full)}}
    return out


def rank_one(mesh, cases, arrays):
    """A mesh of one rank: the sharded step against make_train_step on the
    same parameters and batches (both in this process)."""
    from repro_torch import optim
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import init_zero_opt_state
    from repro_torch.parallel.step import make_sharded_train_step
    out = {}
    for kind in cases:
        cfg = _port_cfg(kind)
        adam = optim.AdamWConfig(**ADAM)
        runs = []
        for sharded in (True, False):
            params = bridge.lm_params_from_arrays(arrays[kind]["params"],
                                                  cfg, device="cpu")
            if sharded:
                pspec = sh.lm_param_specs(cfg)
                ospec = sh.zero_opt_specs(params, pspec, mesh)
                opt = init_zero_opt_state(mesh, params, pspec, ospec)
                step = make_sharded_train_step(cfg, adam, mesh, pspec, ospec)
            else:
                opt = optim.init_opt_state(params)
                step = optim.make_train_step(
                    lambda p, b: tf.lm_train_forward(p, cfg, b), adam)
            losses = []
            for b in _batches(cfg.vocab):
                b = {k: torch.from_numpy(v).long() for k, v in b.items()}
                loss, params, opt = step(params, opt, b)
                losses.append(loss.clone())
            runs.append((losses, keyed_leaves(params),
                         keyed_leaves(opt["m"]) + keyed_leaves(opt["v"])))
        (la, pa, ma), (lb, pb, mb) = runs
        out[kind] = {
            "loss": all(torch.equal(x, y) for x, y in zip(la, lb)),
            "params": [k for (k, x), (_, y) in zip(pa, pb)
                       if not torch.equal(x, y)],
            "moments": [k for (k, x), (_, y) in zip(ma, mb)
                        if not torch.equal(x, y)]}
    return out


@pytest.fixture(scope="module")
def runs():
    """JAX's references (a subprocess) and the port's ranks, side by
    side."""
    from repro_torch.launch.mesh import run_ranks
    arrays = {kind: _jax_params(kind) for kind in ("granite", "tinyllama")}
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.Popen([sys.executable, "-c", _SCRIPT, ref_path],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            got = {}
            axes = ("data", "model")
            for tag in ("2x2", "1x2", "2x1"):
                cases = [k for k, t in STEP_RUNS if t == tag]
                shape = tuple(int(n) for n in tag.split("x"))
                got[tag] = run_ranks(rank_steps, shape, (cases, arrays),
                                     device="cpu", axis=axes)
            got["1x1"] = run_ranks(rank_one, (1, 1),
                                   (("granite", "tinyllama"), arrays),
                                   device="cpu", axis=axes)
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert "JAX_REFERENCE_OK" in stdout, stderr[-3000:]
        with np.load(ref_path) as f:
            ref = {k: f[k] for k in f.files}
    return ref, got, arrays


# --- the spec sets ----------------------------------------------------------

def _port_specs(tree):
    return {k: tuple(s) for k, s in keyed_leaves(tree)}


def _jax_specs(tree):
    import jax
    from jax.sharding import PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _lm_configs(name, size):
    jmod = importlib.import_module(f"repro.configs.{_JAX_MODULES[name]}")
    idx = 0 if size == "CONFIG" else 1
    return LM_CONFIGS[name][idx], getattr(jmod, size)


_ABSTRACT = {}


def _abstract(name, size):
    """JAX's abstract parameter tree (shapes only) of the config."""
    if (name, size) not in _ABSTRACT:
        import jax
        from repro.models import transformer as jtf
        jcfg = _lm_configs(name, size)[1]
        _ABSTRACT[name, size] = jax.eval_shape(
            lambda: jtf.lm_init_params(jax.random.key(0), jcfg))
    return _ABSTRACT[name, size]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("name", sorted(_JAX_MODULES))
def test_lm_param_and_opt_specs_match_jax(name, size, mesh):
    from repro.parallel import sharding as jsh
    pcfg, jcfg = _lm_configs(name, size)
    got, want = sh.lm_param_specs(pcfg), jsh.lm_param_specs(jcfg)
    assert _port_specs(got) == _jax_specs(want)
    assert _port_specs(sh.opt_specs(got)) == _jax_specs(jsh.opt_specs(want))
    # the specs name the parameters the port's init makes
    import jax
    assert set(_port_specs(got)) == {
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(_abstract(name, size))[0]}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("name", sorted(_JAX_MODULES))
def test_zero_opt_specs_match_jax(name, size, mesh):
    from repro.parallel import sharding as jsh
    pcfg, jcfg = _lm_configs(name, size)
    ab = _abstract(name, size)
    m = _mesh_ns(mesh)
    got = sh.zero_opt_specs(ab, sh.lm_param_specs(pcfg), m)
    want = jsh.zero_opt_specs(ab, jsh.lm_param_specs(jcfg), m)
    assert _port_specs(got) == _jax_specs(want)


@pytest.mark.parametrize("batch,max_len", [(8, 4096), (8, 16384),
                                           (1, 16384), (3, 8192)])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", sorted(_JAX_MODULES))
def test_lm_cache_specs_match_jax(name, mesh, batch, max_len):
    """Each branch: the batch split or not, the sequence split (over
    "model", or every axis) or whole, a window's cache whole (gemma3)."""
    from repro.parallel import sharding as jsh
    pcfg, jcfg = _lm_configs(name, "CONFIG")
    m = _mesh_ns(mesh)
    got = sh.lm_cache_specs(pcfg, m, batch, max_len)
    want = jsh.lm_cache_specs(jcfg, m, batch, max_len)
    assert _port_specs(got) == _jax_specs(want)


@pytest.mark.parametrize("family", sorted(_FAMILY))
def test_family_specs_match_jax(family):
    """GIN's and the recommenders' spec sets on JAX's (abstract)
    parameter trees of their published configs."""
    import jax
    from repro.parallel import sharding as jsh
    cfg_mod, model_mod, init = _FAMILY[family]
    cfg = importlib.import_module(f"repro.configs.{cfg_mod}").CONFIG
    jinit = getattr(importlib.import_module(f"repro.models.{model_mod}"),
                    init)
    tree = jax.eval_shape(lambda: jinit(jax.random.key(0), cfg))
    fn = f"{family}_param_specs"
    got = getattr(sh, fn)(tree)
    want = getattr(jsh, fn)(tree)
    assert _port_specs(got) == _jax_specs(want)
    assert any(s for s in _port_specs(got).values()) or family == "gin"


def test_spec_type_normalizes_as_jax():
    from jax.sharding import PartitionSpec as JP
    for entries in [(), (None,), ("model", None), (("data",), None),
                    (("pod", "data"), "model"), (None, None, "model")]:
        assert tuple(sh.P(*entries)) == tuple(JP(*entries))
    assert sh.P(("data",), None) == sh.P("data", None)
    with pytest.raises(ValueError):
        sh.P(3)
    m = _mesh_record("2x2", 1)
    named = sh.tree_named(m, {"a": [sh.P("model"), sh.P()]})
    assert named["a"][0] == sh.NamedSharding(m, sh.P("model"))
    assert named["a"][1].spec == () and named["a"][1].mesh is m


# --- blocks against NamedSharding's shards ----------------------------------

def _port_trees(arrays):
    """granite SMOKE's parameter, opt-state and cache trees as the port's
    tensors (the same bits JAX's script draws)."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim import init_opt_state
    cfg = _port_cfg("granite")
    params = bridge.lm_params_from_arrays(arrays["granite"]["params"], cfg,
                                          device="cpu")
    trees = {"params": params}

    def valued(name, tree):
        keyed = keyed_leaves(tree)
        vals = _block_values(name, {
            k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in keyed})
        from repro_torch._tree import tree_unflatten
        return tree_unflatten(tree, [torch.from_numpy(vals[k])
                                     for k, _ in keyed])

    trees["opt"] = valued("opt", init_opt_state(params))
    for name, (b, s) in CACHES.items():
        trees[name] = valued(name, tf.init_cache(cfg, b, s, torch.float32,
                                                 device="cpu"))
    return cfg, trees


def _full_from_blocks(mesh, spec, blocks):
    """The full leaf from every rank's block (``blocks[r]``: rank r's), in
    one process; ranks that hold the same block hold the same bits."""
    assert len(blocks) == mesh.size
    split = [(d, e) for d, e in enumerate(spec) if e is not None]
    shape = list(blocks[0].shape)
    for dim, axes in split:
        shape[dim] *= mesh.axis_size(axes)
    full = blocks[0].new_empty(shape)
    seen = torch.zeros(shape, dtype=torch.bool)
    for r, blk in enumerate(blocks):
        at = dataclasses.replace(mesh, rank=r)
        index = [slice(None)] * len(shape)
        for dim, axes in split:
            per = blk.shape[dim]
            index[dim] = slice(at.axis_index(axes) * per,
                               (at.axis_index(axes) + 1) * per)
        index = tuple(index)
        if seen[index].any():
            assert torch.equal(full[index], blk), f"rank {r}'s copy differs"
        else:
            full[index] = blk
            seen[index] = True
    assert seen.all()
    return full


@pytest.mark.parametrize("tree", BLOCK_TREES)
@pytest.mark.parametrize("mesh", BLOCK_MESHES)
def test_rank_block_matches_named_sharding(runs, mesh, tree):
    """Rank r's block of every leaf is, bit for bit, the shard JAX places
    on the mesh's r-th device (device id r: JAX's row-major order), and
    the ranks' blocks put the leaf back together."""
    ref, _, arrays = runs
    assert list(ref[f"ids|{mesh}"]) == list(range(len(ref[f"ids|{mesh}"])))
    cfg, trees = _port_trees(arrays)
    m0 = _mesh_record(mesh, 0)
    spec = {"params": lambda: sh.lm_param_specs(cfg),
            "opt": lambda: sh.zero_opt_specs(
                trees["params"], sh.lm_param_specs(cfg), m0)}
    for name, (b, s) in CACHES.items():
        spec[name] = (lambda b=b, s=s: sh.lm_cache_specs(cfg, m0, b, s))
    specs = dict(keyed_leaves(spec[tree]()))
    checked = 0
    for key, leaf in keyed_leaves(trees[tree]):
        blocks = []
        for r in range(m0.size):
            got = sh.rank_block(_mesh_record(mesh, r), leaf, specs[key])
            want = ref[f"block|{mesh}|{tree}|{key}|{r}"]
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{key} rank {r}")
            blocks.append(got)
        assert torch.equal(_full_from_blocks(m0, specs[key], blocks), leaf)
        checked += 1
    assert checked == len(keyed_leaves(trees[tree]))


def test_rank_block_keeps_the_serving_markers():
    m = Mesh("data", 2, 1, None, "gloo", torch.device("cpu"))
    x = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(sh.rank_block(m, x, sh.ROWS), x[2:])
    assert torch.equal(sh.rank_block(m, x, sh.CELLS), x[2:])
    assert sh.rank_block(m, x, sh.REPLICATED) is x
    # under a spec, a whole leaf's block is a copy (F8: no block shares
    # memory with the tree it came from)
    whole = sh.rank_block(m, x, sh.P())
    assert torch.equal(whole, x)
    assert whole.untyped_storage().data_ptr() != \
        x.untyped_storage().data_ptr()
    assert torch.equal(sh.rank_block(m, x, sh.P("data", None)), x[2:])
    with pytest.raises(ValueError, match="multiple"):
        sh.rank_block(_mesh_record("2x2", 0), torch.ones(3, 2),
                      sh.P("model", None))


# --- the sharded step -------------------------------------------------------

def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("kind,mesh", STEP_CASES)
def test_sharded_step_matches_jax(runs, kind, mesh):
    """Two steps: each step's loss within 1e-5 relative, every parameter
    within 2e-5 of JAX's sharded step's."""
    ref, got, _ = runs
    port = got[mesh][kind]
    np.testing.assert_allclose(port["loss"], ref[f"loss|{kind}|{mesh}"],
                               rtol=LOSS_RTOL)
    prefix = f"param|{kind}|{mesh}|"
    keys = [k[len(prefix):] for k in ref if k.startswith(prefix)]
    assert sorted(keys) == sorted(port["params"])
    for key in keys:
        np.testing.assert_allclose(port["params"][key], ref[prefix + key],
                                   rtol=0, atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("kind,mesh", DEFAULT_EPS_CASES)
def test_sharded_step_matches_jax_at_default_eps(runs, kind, mesh):
    """Two steps at the configuration's eps: each step's loss within 1e-5
    relative, every parameter within PARAM_ATOL_DEFAULT_EPS of JAX's
    sharded step's."""
    ref, got, _ = runs
    run = f"{kind}:eps-default"
    port = got[mesh][run]
    np.testing.assert_allclose(port["loss"], ref[f"loss|{run}|{mesh}"],
                               rtol=LOSS_RTOL)
    prefix = f"param|{run}|{mesh}|"
    keys = [k[len(prefix):] for k in ref if k.startswith(prefix)]
    assert sorted(keys) == sorted(port["params"])
    worst = max((float(np.abs(port["params"][k] - ref[prefix + k]).max()), k)
                for k in keys)
    assert worst[0] <= PARAM_ATOL_DEFAULT_EPS, worst


@pytest.mark.parametrize("kind,mesh", STEP_CASES)
def test_gradient_blocks_match_jax(runs, kind, mesh):
    """Step 0: every rank's gradient block of every leaf (the mean over the
    data axes) is its block of JAX's gradient, within 1e-5 relative L2."""
    ref, got, _ = runs
    cfg = _port_cfg(kind)
    specs = dict(keyed_leaves(sh.lm_param_specs(cfg)))
    every = got[mesh][kind]["grads"]
    assert len(every) == int(np.prod([int(n) for n in mesh.split("x")]))
    for r, grads in enumerate(every):
        rec = _mesh_record(mesh, r)
        for key, g in grads.items():
            want = sh.rank_block(rec, torch.from_numpy(
                ref[f"grad|{kind}|{mesh}|{key}"]), specs[key]).numpy()
            assert g.shape == want.shape, key
            assert _rel(g, want) <= GRAD_REL, (key, r, _rel(g, want))


@pytest.mark.parametrize("kind", ["granite", "tinyllama"])
def test_sharded_step_bit_equal_at_one_rank(runs, kind):
    """At (1, 1) the sharded step (EP at mp 1, ZeRO at dp 1) runs
    make_train_step's operations: losses, parameters and moments bit for
    bit after two steps."""
    one = runs[1]["1x1"][kind]
    assert one["loss"] and not one["params"] and not one["moments"], one


# --- meshes and constrain ---------------------------------------------------

@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_refuses_a_small_world(monkeypatch, multi_pod, n):
    """JAX's kind of error (RuntimeError, naming the count) on a world
    smaller than the production mesh."""
    from repro_torch.launch.mesh import make_production_mesh
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match=f"need {n} ranks"):
        make_production_mesh(multi_pod=multi_pod)


def test_mesh_record_numbers_ranks_as_jax():
    """Row-major coordinates; an axis tuple's index is JAX's block
    index."""
    for r in range(8):
        m = _mesh_record("2x2x2", r)
        pod, data, model = r // 4, (r // 2) % 2, r % 2
        assert m.coords == {"pod": pod, "data": data, "model": model}
        assert m.axis_index(("pod", "data")) == pod * 2 + data
        assert m.axis_index(("model", "pod")) == model * 2 + pod
        assert m.axis_size(("pod", "data")) == 4
        assert m.axis_size("model") == 2
    with pytest.raises(ValueError):
        Mesh("data", 4, 0, None, "gloo", torch.device("cpu"),
             names=("data", "model"), dims=(2, 3))


def test_constrain_returns_its_input():
    """JAX's constraint moves placement, never values: the port returns
    ``x``; under a mesh, axes the mesh lacks are dropped (no error), and
    a spec longer than x's dims raises, as JAX's does."""
    from repro_torch.parallel import constrain, mesh_context
    x = torch.ones(4, 3)
    assert constrain(x, sh.P("model", "data")) is x
    with mesh_context(_mesh_record("2x2", 0)):
        assert constrain(x, sh.P(("pod", "data"), "expert")) is x
        with pytest.raises(ValueError):
            constrain(x, sh.P(None, None, "model"))
