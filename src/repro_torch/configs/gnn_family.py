"""The GNN family's input shapes, FLOP counts and smoke steps (port of
the corresponding part of ``repro.configs.gnn_family``) for gin-tu.

JAX's ``make_gin_arch`` builds an ``ArchSpec`` with ``PartitionSpec``s
for its dry-run tools; that half waits with ``configs.common``, the model
side's sharding and the dry-run tools (ROADMAP.md item 13). What the port
keeps of it: ``GNN_SHAPES`` (each full-graph edge list padded to a
multiple of ``EDGE_PAD``, masked), ``shape_config(sname)`` (its
``shape_cfg``), ``gin_flops`` (its ``model_flops``) and its ``smoke()``
body as ``smoke()``: one AdamW train step on the full-graph regime and
the sampled and molecule losses at a reduced size.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike, cpu_generator, resolve_device
from repro_torch._tree import tree_map
from repro_torch.models import gnn
from repro_torch.optim import AdamWConfig, init_opt_state, make_train_step

from .gin_tu import CONFIG as GIN_TU

__all__ = ["GNN_SHAPES", "EDGE_PAD", "padded_edges", "shape_config",
           "gin_flops", "smoke"]

_ADAM = AdamWConfig(lr=1e-3, total_steps=10_000)
EDGE_PAD = 512

GNN_SHAPES = {
    # name: (regime, params). Edge counts get padded to 512 multiples.
    "full_graph_sm": dict(regime="full", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg": dict(regime="sampled", batch_nodes=1024, fanout=(15, 10),
                         d_feat=602, n_classes=41),
    "ogb_products": dict(regime="full", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100, n_classes=47),
    "molecule": dict(regime="mol", n_graphs=128, n_nodes=30, d_feat=32,
                     n_classes=2),
}


def padded_edges(n_edges: int) -> int:
    """The edge list's length once padded to a multiple of EDGE_PAD."""
    return -(-n_edges // EDGE_PAD) * EDGE_PAD


def shape_config(sname: str, base: gnn.GINConfig = GIN_TU) -> gnn.GINConfig:
    """``base``'s depth and width at shape ``sname``'s features, classes
    and fanout (JAX's ``shape_cfg``)."""
    s = GNN_SHAPES[sname]
    return gnn.GINConfig(
        name=f"{base.name}:{sname}", n_layers=base.n_layers,
        d_hidden=base.d_hidden, d_feat=s["d_feat"],
        n_classes=s["n_classes"], fanout=s.get("fanout", (15, 10)))


def gin_flops(cfg: gnn.GINConfig, sname: str) -> float:
    """Model FLOPs of one training step of ``cfg`` (the base config) at
    shape ``sname``: 3x the forward's (JAX's ``model_flops``; the edge
    count unpadded)."""
    s = GNN_SHAPES[sname]
    c = shape_config(sname, cfg)
    h = c.d_hidden
    if s["regime"] == "full":
        n, e = s["n_nodes"], s["n_edges"]
        per_layer = 2 * n * s["d_feat"] * h + 2 * n * h * h + e * h
        fwd = per_layer + (c.n_layers - 1) * (4 * n * h * h + e * h)
    elif s["regime"] == "sampled":
        b, (f1, f2) = s["batch_nodes"], s["fanout"]
        nodes = b * (1 + f1 + f1 * f2)
        fwd = 2 * nodes * s["d_feat"] * h + 4 * nodes * h * h
    else:
        g, n = s["n_graphs"], s["n_nodes"]
        fwd = c.n_layers * (g * (2 * n * s["d_feat"] * h
                                 + 4 * n * h * h + 2 * n * n * h))
    return 3.0 * fwd


def smoke(device: DeviceLike = None) -> Dict[str, object]:
    """gin's reduced config (3 layers, hidden 16, 8 features, 3 classes,
    fanout (3, 2)): one AdamW train step on a 24-node, 64-edge graph, and
    the sampled and molecule losses at the initial parameters, as JAX's
    ``arch.smoke()``. Returns ``{"ok", "loss", "sampled_loss",
    "mol_loss"}``. Runs on ``cuda`` unless ``device`` names another."""
    dev = resolve_device(device)
    c = gnn.GINConfig(name="gin-smoke", n_layers=3, d_hidden=16, d_feat=8,
                      n_classes=3, fanout=(3, 2))
    params = gnn.gin_init_params(c, seed=0, device=dev)
    gen = cpu_generator(1)

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def randint(high, *shape):
        return torch.randint(0, high, shape, generator=gen).to(dev)

    n, e = 24, 64
    batch = {"feats": normal(n, 8), "edge_src": randint(n, e),
             "edge_dst": randint(n, e),
             "edge_mask": torch.ones(e, device=dev),
             "labels": randint(3, n), "label_mask": torch.ones(n, device=dev)}
    step = make_train_step(lambda p, b: gnn.gin_full_loss(p, c, b), _ADAM)
    # a copy: the port's AdamW updates in place, JAX's step returns new
    # parameters and the losses below read the initial ones
    trained = tree_map(lambda t: t.detach().clone(), params)
    loss, _, _ = step(trained, init_opt_state(trained), batch)
    sb = {"feat_l0": normal(4, 8), "feat_l1": normal(4, 3, 8),
          "feat_l2": normal(4, 3, 2, 8), "labels": randint(3, 4)}
    mb = {"feats": normal(5, 6, 8), "adj": torch.ones((5, 6, 6), device=dev),
          "labels": randint(3, 5)}
    with torch.no_grad():
        l2 = gnn.gin_sampled_loss(params, c, sb)
        l3 = gnn.gin_mol_loss(params, c, mb)
    vals = [float(x) for x in (loss, l2, l3)]
    return {"ok": all(np.isfinite(v) for v in vals), "loss": vals[0],
            "sampled_loss": vals[1], "mol_loss": vals[2]}
