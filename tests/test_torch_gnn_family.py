"""repro_torch.configs.gnn_family and gin_tu against JAX's
repro.configs.gnn_family: GNN_SHAPES value for value, the padded edge
lists and the parameter shapes of every shape, gin_flops equal to JAX's
model_flops; smoke() finite; the registry and the train launcher run
gin-tu."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch._tree import keyed_leaves  # noqa: E402
from repro_torch.configs import gin_tu, gnn_family  # noqa: E402
from repro_torch.configs.registry import config_module  # noqa: E402
from repro_torch.models import gnn  # noqa: E402


@pytest.fixture(scope="module")
def jarch():
    jax = pytest.importorskip("jax")
    from repro.configs import gin_tu as jgin
    from repro.configs import gnn_family as jfam
    return jax, jfam, jgin.get_arch()


def test_shapes_equal_jax(jarch):
    _, jfam, _ = jarch
    assert gnn_family.GNN_SHAPES == jfam.GNN_SHAPES


@pytest.mark.parametrize("sname", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule"])
def test_shape_config_flops_and_batch_equal_jax(jarch, sname):
    """The parameter tree of shape_config(sname) has JAX's abstract
    state's keys and shapes; full-graph edge lists pad as JAX's batch
    struct does; gin_flops equals JAX's model_flops."""
    jax, _, arch = jarch
    jparams, _, jbatch = arch.abstract_args(sname)
    want = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    cfg = gnn_family.shape_config(sname)
    assert cfg.name == f"gin-tu:{sname}"
    got = {k: tuple(v.shape) for k, v in keyed_leaves(
        gnn.gin_init_params(cfg, seed=0, device="cpu"))}
    assert got == want
    s = gnn_family.GNN_SHAPES[sname]
    if s["regime"] == "full":
        ep = gnn_family.padded_edges(s["n_edges"])
        assert jbatch["edge_src"].shape == (ep,) and ep % 512 == 0
    assert gnn_family.gin_flops(gin_tu.CONFIG, sname) == \
        arch.model_flops(sname)


def test_smoke_is_finite():
    out = gnn_family.smoke(device="cpu")
    assert out["ok"] and all(np.isfinite(out[k]) for k in (
        "loss", "sampled_loss", "mol_loss"))


def test_registry_resolves_gin_tu(jarch):
    import importlib
    from repro.configs.registry import ARCH_MODULES as JAX_ARCHS
    mod = config_module("gin-tu")
    assert mod is gin_tu
    jd = dataclasses.asdict(importlib.import_module(
        JAX_ARCHS["gin-tu"]).CONFIG)
    td = dataclasses.asdict(mod.CONFIG)
    assert np.dtype(jd.pop("dtype")).name == str(td.pop("dtype")).split(
        ".")[-1]
    assert jd == td


def test_train_launcher_runs_gin_tu(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "gin-tu"], device="cpu")
    assert out["ok"] and np.isfinite(out["loss"])
    assert "gin-tu: non-LM arch" in capsys.readouterr().out
