"""GIN (Graph Isomorphism Network, Xu et al. 2019) in three data regimes
(port of ``repro.models.gnn``):

  h_i' = MLP_l( (1 + eps_l) * h_i + sum_{j in N(i)} h_j )

Regimes (one per input shape of ``configs.gnn_family``):
  * full graph  (N, F) node features and an edge list; the neighbour sum
                is ``kernels.graph_agg.gin_aggregate`` over a ``GraphCSR``
                (JAX's ``segment_sum`` of the masked messages: its bits on
                the CPU, the fixed-order CSR kernel on the card). Build
                the CSR once per graph (``build_csr``) and pass it in: the
                sorts are then not redone at every call.
  * sampled     layered fanout batches (``data.graph``'s sampler); the
                fanout sums are plain torch sums.
  * molecules   batched dense small graphs: the adjacency product
                (``einsum("gij,gjf->gif")``, a batched matmul).

Parameters are dicts and lists of tensors with the JAX pytree's names and
shapes (``layers[i].mlp.{w1,b1,w2,b2}``, ``layers[i].eps``, ``head``), so
``bridge.gin_params_from_arrays`` carries a JAX model's parameters in. The
init draws from a ``torch.Generator`` seeded with ``seed`` on the target
device (not JAX's streams).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels.graph_agg import GraphCSR, build_csr, gin_aggregate

from .layers import he_init

__all__ = ["GINConfig", "gin_init_params", "gin_full_forward",
           "gin_sampled_forward", "gin_mol_forward", "gin_full_loss",
           "gin_sampled_loss", "gin_mol_loss"]

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 7
    fanout: Tuple[int, ...] = (15, 10)     # sampled regime depth/fanouts
    dtype: torch.dtype = torch.float32


def _mlp_init(gen, d_in, d_h, dtype):
    return {"w1": he_init(gen, (d_in, d_h), d_in, dtype),
            "b1": torch.zeros((d_h,), dtype=dtype, device=gen.device),
            "w2": he_init(gen, (d_h, d_h), d_h, dtype),
            "b2": torch.zeros((d_h,), dtype=dtype, device=gen.device)}


def _mlp(p, x):
    return F.relu(F.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])


def gin_init_params(cfg: GINConfig, seed: int = 0,
                    device: DeviceLike = None) -> Params:
    """He-initialised MLPs (zero biases), eps 0, and the head, drawn from
    ``seed`` on ``device`` (``cuda`` unless named)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_feat if i == 0 else cfg.d_hidden
        layers.append({"mlp": _mlp_init(gen, d_in, cfg.d_hidden, cfg.dtype),
                       "eps": torch.zeros((), dtype=cfg.dtype,
                                          device=gen.device)})
    return {"layers": layers,
            "head": he_init(gen, (cfg.d_hidden, cfg.n_classes),
                            cfg.d_hidden, cfg.dtype)}


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]


# ----------------------------------------------------------- full graph

def gin_full_forward(params: Params, cfg: GINConfig, feats: torch.Tensor,
                     edge_src: torch.Tensor, edge_dst: torch.Tensor,
                     edge_mask: Optional[torch.Tensor] = None,
                     csr: Optional[GraphCSR] = None) -> torch.Tensor:
    """feats (N, F); edge_{src,dst} (E,). Returns logits (N, n_classes).

    ``edge_mask`` (E,) zeroes padding edges (edge lists are padded to a
    multiple of 512). ``csr``: ``build_csr(edge_src, edge_dst, edge_mask,
    N)`` made before; without it the call builds one."""
    h = feats.to(cfg.dtype)
    n = feats.shape[0]
    if csr is None:
        csr = build_csr(edge_src, edge_dst, edge_mask, n)
    for lp in params["layers"]:
        agg = gin_aggregate(h, csr)
        h = _mlp(lp["mlp"], (1.0 + lp["eps"]) * h + agg)
    return h @ params["head"]


def gin_full_loss(params: Params, cfg: GINConfig,
                  batch: Dict[str, Any]) -> torch.Tensor:
    """Masked mean NLL over the nodes: sum(nll * label_mask) /
    max(sum(label_mask), 1). ``batch`` may hold a prebuilt ``csr``."""
    logits = gin_full_forward(params, cfg, batch["feats"],
                              batch["edge_src"], batch["edge_dst"],
                              batch.get("edge_mask"), batch.get("csr"))
    labels = batch["labels"]
    mask = batch.get("label_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    nll = _nll(logits, labels)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


# ------------------------------------------------------------- sampled

def gin_sampled_forward(params: Params, cfg: GINConfig,
                        feat_levels: Sequence[torch.Tensor]) -> torch.Tensor:
    """feat_levels[d]: (B, f_1, ..., f_d, F) gathered features at hop d.

    Depth = len(fanout); aggregates leaves up to the seed nodes with the
    first ``depth`` GIN layers. Returns (B, n_classes)."""
    depth = len(cfg.fanout)
    hs = [f.to(cfg.dtype) for f in feat_levels]            # hop 0..depth
    for li in range(depth):
        lp = params["layers"][li]
        new_hs = []
        for lvl in range(depth - li):                      # hops 0..D-li-1
            agg = torch.sum(hs[lvl + 1], dim=-2)           # (..., fan, F')
            new_hs.append(_mlp(lp["mlp"], (1.0 + lp["eps"]) * hs[lvl] + agg))
        hs = new_hs
    return hs[0] @ params["head"]


def gin_sampled_loss(params: Params, cfg: GINConfig,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    depth = len(cfg.fanout)
    levels = [batch[f"feat_l{d}"] for d in range(depth + 1)]
    logits = gin_sampled_forward(params, cfg, levels)
    return torch.mean(_nll(logits, batch["labels"]))


# ----------------------------------------------------------- molecules

def gin_mol_forward(params: Params, cfg: GINConfig, feats: torch.Tensor,
                    adj: torch.Tensor) -> torch.Tensor:
    """Batched dense graphs: feats (G, n, F), adj (G, n, n). Sum readout;
    returns (G, n_classes)."""
    h = feats.to(cfg.dtype)
    a = adj.to(cfg.dtype)
    for lp in params["layers"]:
        agg = torch.einsum("gij,gjf->gif", a, h)
        h = _mlp(lp["mlp"], (1.0 + lp["eps"]) * h + agg)
    return torch.sum(h, dim=1) @ params["head"]


def gin_mol_loss(params: Params, cfg: GINConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = gin_mol_forward(params, cfg, batch["feats"], batch["adj"])
    return torch.mean(_nll(logits, batch["labels"]))
