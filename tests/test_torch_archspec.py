"""The port's ``ArchSpec``s against the JAX package's (twins of
``tests/test_configs_smoke.py``'s pins and of what JAX's dry-run reads):
the 10 archs, their 40 cells and the 4 documented skips; ``model_flops``
cell for cell; every ``abstract_args`` leaf's shape and dtype against
JAX's ``eval_shape`` trees; ``arg_specs`` / ``out_specs`` entry for entry
on both production meshes (JAX's on ``AbstractMesh``); and a rank's
argument bytes, from the port's ``rank_block`` on the fake arguments,
against the sum of JAX's ``NamedSharding(AbstractMesh, spec).shard_shape``
bytes, for every runnable cell. Then the kernels' custom ops: their fake
outputs against their plain versions' shapes and dtypes, their FLOP
formulas against the documented counts; and each arch's smoke step on
the CPU. JAX is imported inside the tests (no devices: ``AbstractMesh``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch._tree import keyed_leaves  # noqa: E402
from repro_torch.configs import all_arch_names, get_arch  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.context import Mesh  # noqa: E402

ARCHS = all_arch_names()
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
SKIPS = [("granite-moe-1b-a400m", "long_500k"), ("olmoe-1b-7b", "long_500k"),
         ("stablelm-1.6b", "long_500k"), ("tinyllama-1.1b", "long_500k")]


def _jax_arch(name):
    pytest.importorskip("jax")
    from repro.configs import get_arch as jax_get_arch
    return jax_get_arch(name)


def _abstract_mesh(tag):
    from jax.sharding import AbstractMesh
    shape, axes = MESHES[tag]
    return AbstractMesh(shape, axes)


def _port_mesh(tag, rank=0):
    shape, axes = MESHES[tag]
    return Mesh(axis=axes[0], size=int(np.prod(shape)), rank=rank,
                group=None, backend="fake", device=torch.device("meta"),
                names=axes, dims=shape)


def _entry(e):
    """A spec entry as a tuple of axis names (None: whole)."""
    if e is None:
        return None
    return (e,) if isinstance(e, str) else tuple(e)


def _jax_keyed_specs(tree):
    import jax
    from jax.sharding import PartitionSpec
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {jax.tree_util.keystr(p): tuple(_entry(e) for e in s)
            for p, s in flat}


def _port_keyed_specs(tree):
    return {k: tuple(_entry(e) for e in s) for k, s in keyed_leaves(tree)}


def _jax_keyed_leaves(tree):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): v for p, v in flat}


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def test_registry_cells_and_skips():
    assert len(ARCHS) == 10
    assert {get_arch(a).family for a in ARCHS} == {"lm", "gnn", "recsys"}
    assert sum(len(get_arch(a).shapes) for a in ARCHS) == 40
    skips = [(a, s.name) for a in ARCHS
             for s in get_arch(a).shapes.values() if s.skip]
    assert sorted(skips) == SKIPS
    assert sum(len(get_arch(a).runnable_shapes()) for a in ARCHS) == 36
    for a in ARCHS:
        assert get_arch(a) is get_arch(a)          # built once
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


def test_cells_and_skips_match_jax():
    for a in ARCHS:
        port, jarch = get_arch(a), _jax_arch(a)
        assert port.family == jarch.family and port.name == jarch.name
        assert list(port.shapes) == list(jarch.shapes)
        for s, sdef in port.shapes.items():
            j = jarch.shapes[s]
            assert (sdef.name, sdef.kind, sdef.skip, sdef.desc) == (
                j.name, j.kind, j.skip, j.desc), (a, s)


def test_not_ported_cells_are_the_lm_prefill_and_decode_cells():
    """No cell is left without a rank program: the 11 LM prefill and
    decode cells (once without one) build theirs on both production
    meshes, as every runnable cell does, and ``ArchSpec`` has no
    ``not_ported`` field (JAX's has none)."""
    import dataclasses

    from repro_torch.configs.common import ArchSpec
    from repro_torch.parallel import step as pstep
    assert "not_ported" not in {f.name for f in dataclasses.fields(ArchSpec)}
    serve = [(a, s) for a in ARCHS for s in get_arch(a).runnable_shapes()
             if get_arch(a).shapes[s].kind in ("prefill", "decode")]
    assert len(serve) == 11
    built = 0
    for tag in MESHES:
        mesh = _port_mesh(tag)
        for a in ARCHS:
            for s in get_arch(a).runnable_shapes():
                assert callable(get_arch(a).step_fn(s, mesh)), (a, s, tag)
                built += 1
        for a, s in serve:
            fn = get_arch(a).step_fn(s, mesh)
            want = (pstep.make_sharded_prefill if get_arch(a).shapes[s].kind
                    == "prefill" else pstep.make_sharded_decode_step)
            assert fn.__qualname__.startswith(want.__name__), (a, s)
    assert built == 2 * 36


@pytest.mark.parametrize("name", ARCHS)
def test_model_flops_match_jax(name):
    port, jarch = get_arch(name), _jax_arch(name)
    for s in port.shapes:
        assert port.model_flops(s) == jarch.model_flops(s), s
        if s in port.runnable_shapes():
            assert port.model_flops(s) > 0


@pytest.mark.parametrize("name", ARCHS)
def test_abstract_args_match_jax(name):
    """Every runnable cell's arguments, leaf for leaf: the same keys,
    shapes and dtypes as JAX's ``ShapeDtypeStruct`` trees, as fake
    tensors that hold no memory."""
    port, jarch = get_arch(name), _jax_arch(name)
    for s in port.runnable_shapes():
        got = port.abstract_args(s, "meta")
        want = jarch.abstract_args(s)
        assert isinstance(got, tuple) and len(got) == len(want), s
        for g, w in zip(got, want):
            gk = dict(keyed_leaves(g))
            wk = _jax_keyed_leaves(w)
            assert list(gk) == list(wk), (s, list(gk)[:4], list(wk)[:4])
            for k, leaf in gk.items():
                assert tuple(leaf.shape) == tuple(wk[k].shape), (s, k)
                assert str(leaf.dtype).split(".")[-1] == \
                    str(wk[k].dtype), (s, k)
                assert leaf.device.type == "meta"


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_specs_match_jax(name, tag):
    port, jarch = get_arch(name), _jax_arch(name)
    jm, pm = _abstract_mesh(tag), _port_mesh(tag)
    for s in port.runnable_shapes():
        for fn in ("arg_specs", "out_specs"):
            got = _port_keyed_specs(getattr(port, fn)(s, pm))
            want = _jax_keyed_specs(getattr(jarch, fn)(s, jm))
            assert got == want, (s, fn)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_argument_bytes_match_jax_shard_shapes(name, tag):
    """A rank's blocks of every argument (``rank_block`` on the fake
    global arguments, ranks 0 and the last) against the bytes of JAX's
    shards, ``NamedSharding(AbstractMesh, spec).shard_shape``: equal for
    every runnable cell."""
    from jax.sharding import NamedSharding
    port, jarch = get_arch(name), _jax_arch(name)
    jm = _abstract_mesh(tag)
    last = int(np.prod(MESHES[tag][0])) - 1
    for s in port.runnable_shapes():
        jargs = _jax_keyed_leaves(jarch.abstract_args(s))
        jspecs = _jax_keyed_specs(jarch.arg_specs(s, jm))
        want = 0
        for k, leaf in jargs.items():
            from jax.sharding import PartitionSpec
            spec = PartitionSpec(*jspecs[k])
            shard = NamedSharding(jm, spec).shard_shape(leaf.shape)
            want += int(np.prod(shard)) * leaf.dtype.itemsize
        args = port.abstract_args(s, "meta")
        for rank in (0, last):
            pm = _port_mesh(tag, rank)
            blocks = sh.shard_tree(pm, args, port.arg_specs(s, pm))
            got = sum(t.numel() * t.element_size()
                      for _, t in keyed_leaves(blocks))
            assert got == want, (s, rank, got, want)


# --- the kernels' custom ops ------------------------------------------------

def _fake_flops(fn, *args):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode(), FlopCounterMode(display=False) as fc:
        out = fn(*(torch.empty(a.shape, dtype=a.dtype, device="meta")
                   for a in args))
    return out, fc.get_total_flops()


@pytest.mark.parametrize("window", [None, 5])
def test_k5_op_fake_output_and_flops(window):
    from repro_torch.kernels import flash_attention as fa
    b, s, h, kv, dh = 2, 24, 4, 2, 16
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, h, dh, generator=g)
    k, v = (torch.randn(b, s, kv, dh, generator=g) for _ in range(2))
    want = fa.flash_attention_fwd_plain(q, k, v, window)
    before = fa.flash_attention_fwd.launches
    out, flops = _fake_flops(lambda *t: fa.flash_attention_fwd(*t, window),
                             q, k, v)
    assert fa.flash_attention_fwd.launches == before + 1
    assert out.shape == want.shape and out.dtype == want.dtype
    pairs = sum(min(i + 1, window or s) for i in range(s))
    assert fa.causal_pairs(s, window) == pairs
    assert flops == 4 * b * h * dh * pairs
    # the documented count at path 3's shape: 2.75e11
    assert fa.k5_flops(4, 4096, 32, 64) == 4 * 4 * 32 * 64 * 4096 * 4097 // 2
    assert abs(fa.k5_flops(4, 4096, 32, 64) - 2.75e11) < 0.01e11


@pytest.mark.parametrize("tied", [False, True])
def test_k6_op_fake_output_and_flops(tied):
    from repro_torch.kernels import fused_ce as fce
    t, d, v = 12, 16, 40
    g = torch.Generator().manual_seed(1)
    h = torch.randn(t, d, generator=g)
    w = torch.randn(v, d, generator=g).T if tied else torch.randn(
        d, v, generator=g)
    labels = torch.randint(0, v, (t,), generator=g)
    want = fce.fused_ce_fwd(h, w, labels)
    out, flops = _fake_flops(lambda *a: fce.fused_ce_fwd(*a), h, w, labels)
    assert out.shape == want.shape and out.dtype == want.dtype
    assert flops == 2 * t * d * v


def test_aggregate_op_fake_output_and_flops():
    from repro_torch.kernels import graph_agg as ga
    g = torch.Generator().manual_seed(2)
    n, e, f = 9, 30, 5
    src, dst = (torch.randint(0, n, (e,), generator=g) for _ in range(2))
    csr = ga.build_csr(src, dst, None, n)
    x = torch.randn(n, f, generator=g)
    want = ga.csr_gather_sum_plain(x, csr.fwd)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    before = ga.csr_gather_sum.launches
    with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
            FlopCounterMode(display=False) as fc:
        fsrc, fdst = (mode.from_tensor(t).to("meta") for t in (src, dst))
        fcsr = ga.build_csr(fsrc, fdst, None, n)
        out = ga.csr_gather_sum(torch.empty(n, f, device="meta"), fcsr.fwd)
    assert ga.csr_gather_sum.launches == before + 1
    assert out.shape == want.shape and out.dtype == want.dtype
    assert fc.get_total_flops() == 2 * e * f


def test_static_shape_rewrites_are_bit_equal():
    """``build_csr``'s row counts (``index_add_``), the plain version's
    edge rows (``searchsorted``) and the Switch aux's counts keep their
    values: the same as ``bincount`` / ``repeat_interleave``."""
    from repro_torch.kernels import graph_agg as ga
    from repro_torch.kernels.graph_agg.ref import gather_sum_ref
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(3)
    n, e = 50, 400
    src, dst = (torch.randint(0, n, (e,), generator=g) for _ in range(2))
    csr = ga.build_csr(src, dst, torch.rand(e, generator=g), n)
    counts = torch.bincount(dst, minlength=n)
    assert torch.equal((csr.fwd.rowptr[1:] - csr.fwd.rowptr[:-1]).long(),
                       counts)
    x = torch.randn(n, 6, generator=g)
    rows = torch.repeat_interleave(torch.arange(n), counts)
    assert torch.equal(ga.csr_gather_sum_plain(x, csr.fwd), gather_sum_ref(
        x, csr.fwd.col, rows, csr.fwd.w, n))
    mcfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff=4)
    x2d = torch.randn(33, 6, generator=g)
    router = torch.randn(6, 8, generator=g)
    _, topi, aux = moe._route(x2d, router, mcfg)
    probs = torch.softmax(x2d.float() @ router, dim=-1)
    f_e = torch.bincount(topi.reshape(-1), minlength=8).float() / (33 * 2)
    assert torch.equal(aux, 8 * torch.sum(f_e * probs.mean(dim=0)))


@pytest.mark.parametrize("name", ARCHS)
def test_arch_smoke(name):
    out = get_arch(name).smoke("cpu")
    assert out["ok"], out
