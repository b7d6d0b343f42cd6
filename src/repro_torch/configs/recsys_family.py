"""RecSys-family ``ArchSpec`` builders (port of
``repro.configs.recsys_family``): train_batch / serve_p99 / serve_bulk /
retrieval_cand cells for sasrec, dien, autoint and two-tower retrieval,
with their FLOP counts (``*_flops``, JAX's ``model_flops``) and smoke
steps (``smoke(name)``: one AdamW train step and one serve call at a
reduced size).

The specs are JAX's (``parallel.sharding.*_param_specs``: the embedding
tables split over "model", the rest whole; the rows over the data axes,
the candidates of ``retrieval_cand`` over every axis). The rank programs
(``parallel.step``): the train cells ``make_sharded_step`` (tables
gathered at use, the gradient's mean over the data axes, each rank's
AdamW update), the serve cells ``make_serve_step`` on the rank's rows or
candidates, the two-tower retrieval ``twotower_retrieval_step``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, cpu_generator, resolve_device
from repro_torch.core import MPADConfig, fit_mpad
from repro_torch.models import recsys as rs
from repro_torch.optim import AdamWConfig, init_opt_state, make_train_step

from .common import ArchSpec, ShapeDef, abstract_tensor, abstract_tree

__all__ = ["RECSYS_SHAPES", "sasrec_flops", "dien_flops", "autoint_flops",
           "twotower_flops", "smoke", "make_sasrec_arch", "make_dien_arch",
           "make_autoint_arch", "make_twotower_arch"]

_ADAM = AdamWConfig(lr=1e-3, total_steps=100_000)

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    # spec says 1,000,000 candidates; padded to 2^20 for even sharding
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=1_048_576),
}

_TOPK = 100


def sasrec_flops(cfg: rs.SASRecConfig, sname: str,
                 table: Optional[dict] = None) -> float:
    s = (RECSYS_SHAPES if table is None else table)[sname]
    d, L = cfg.embed_dim, cfg.seq_len
    per_ex = cfg.n_blocks * (8 * L * d * d + 4 * L * L * d)
    if s["kind"] == "train":
        return 3.0 * s["batch"] * (per_ex + 4 * L * d)
    scan = 2.0 * cfg.n_items * d      # last-state x catalog
    return s["batch"] * (per_ex + scan)


def dien_flops(cfg: rs.DIENConfig, sname: str,
               table: Optional[dict] = None) -> float:
    s = (RECSYS_SHAPES if table is None else table)[sname]
    e2, h, L = cfg.embed_dim * 2, cfg.gru_dim, cfg.seq_len
    gru = 6 * L * (e2 * h + h * h)
    augru = 6 * L * (h * h + h * h) + 2 * L * (h + e2)
    mlp = 2 * ((h + 2 * e2) * 200 + 200 * 80 + 80)
    if s["kind"] == "train":
        return 3.0 * s["batch"] * (gru + augru + mlp)
    n = s.get("n_candidates", s["batch"])
    shared = gru if sname == "retrieval_cand" else n * gru
    return shared + n * (augru + mlp)


def autoint_flops(cfg: rs.AutoIntConfig, sname: str,
                  table: Optional[dict] = None) -> float:
    s = (RECSYS_SHAPES if table is None else table)[sname]
    f, d_out = cfg.n_fields, cfg.n_heads * cfg.d_attn
    per_ex = cfg.n_attn_layers * (8 * f * cfg.embed_dim * d_out
                                  + 4 * f * f * d_out) + 2 * f * d_out
    n = s.get("n_candidates", s["batch"])
    mult = 3.0 if s["kind"] == "train" else 1.0
    return mult * n * per_ex


def twotower_flops(cfg: rs.TwoTowerConfig, sname: str, mpad_dim: int = 64,
                   rerank: int = 256, table: Optional[dict] = None) -> float:
    s = (RECSYS_SHAPES if table is None else table)[sname]
    dims = (cfg.field_dim * 2,) + tuple(cfg.tower_dims)
    tower = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    if s["kind"] == "train":
        return 3.0 * s["batch"] * (2 * tower) + \
            3.0 * 2 * s["batch"] * cfg.n_negatives * cfg.embed_dim
    if sname == "retrieval_cand":
        n = s["n_candidates"]
        return tower + 2.0 * n * mpad_dim + 2.0 * rerank * cfg.embed_dim
    return s["batch"] * 2 * tower


def _randint(gen, shape, high, dev):
    return torch.randint(0, high, shape, generator=gen,
                         dtype=torch.int32).to(dev)


def _train_step(loss_fn, params, batch) -> float:
    step = make_train_step(loss_fn, _ADAM)
    loss, _, _ = step(params, init_opt_state(params), batch)
    return float(loss)


def _sasrec_smoke(dev) -> Dict[str, object]:
    c = rs.SASRecConfig(name="sasrec-smoke", n_items=200, seq_len=12)
    p = rs.sasrec_init(c, seed=0, device=dev)
    gen = cpu_generator(1)
    b = {k: _randint(gen, (4, 12), 200, dev) for k in ("seq", "pos", "neg")}
    loss = _train_step(lambda pp, bb: rs.sasrec_loss(pp, c, bb), p, b)
    s, _ = rs.sasrec_serve_topk(p, c, b["seq"], k=7, item_chunk=64)
    ok = bool(np.isfinite(loss)) and tuple(s.shape) == (4, 7)
    return {"ok": ok, "loss": loss, "topk_shape": tuple(s.shape)}


def _dien_smoke(dev) -> Dict[str, object]:
    c = rs.DIENConfig(name="dien-smoke", n_items=300, n_cats=20, seq_len=6)
    p = rs.dien_init(c, seed=0, device=dev)
    gen = cpu_generator(1)
    b = {"hist_items": _randint(gen, (4, 6), 300, dev),
         "hist_cats": _randint(gen, (4, 6), 20, dev),
         "target_item": _randint(gen, (4,), 300, dev),
         "target_cat": _randint(gen, (4,), 20, dev),
         "neg_items": _randint(gen, (4, 6), 300, dev),
         "neg_cats": _randint(gen, (4, 6), 20, dev),
         "label": (torch.rand((4,), generator=gen) > 0.5).float().to(dev)}
    loss = _train_step(lambda pp, bb: rs.dien_loss(pp, c, bb), p, b)
    sc = rs.dien_score(p, c, {
        "hist_items": b["hist_items"][:1], "hist_cats": b["hist_cats"][:1],
        "cand_items": torch.arange(32, device=dev),
        "cand_cats": torch.zeros(32, dtype=torch.int32, device=dev)})
    ok = bool(np.isfinite(loss)) and tuple(sc.shape) == (32,)
    return {"ok": ok, "loss": loss, "scores": tuple(sc.shape)}


def _autoint_smoke(dev) -> Dict[str, object]:
    c = rs.AutoIntConfig(name="autoint-smoke", n_fields=6,
                         vocab_per_field=50)
    p = rs.autoint_init(c, seed=0, device=dev)
    gen = cpu_generator(1)
    b = {"field_ids": _randint(gen, (8, 6), 50, dev),
         "label": (torch.rand((8,), generator=gen) > 0.5).float().to(dev)}
    loss = _train_step(lambda pp, bb: rs.autoint_loss(pp, c, bb), p, b)
    sc = rs.autoint_score_candidates(
        p, c, torch.zeros((5,), dtype=torch.int32, device=dev),
        torch.arange(32, device=dev), chunk=16)
    ok = bool(np.isfinite(loss)) and tuple(sc.shape) == (32,)
    return {"ok": ok, "loss": loss}


def _twotower_smoke(dev) -> Dict[str, object]:
    c = rs.TwoTowerConfig(name="tt-smoke", n_users=200, n_items=100,
                          n_negatives=16)
    p = rs.twotower_init(c, seed=0, device=dev)
    gen = cpu_generator(1)
    b = {"user_ids": _randint(gen, (8,), 200, dev),
         "hist_ids": _randint(gen, (8, c.n_user_feats), 100, dev),
         "pos_items": _randint(gen, (8,), 100, dev),
         "neg_items": _randint(gen, (16,), 100, dev),
         "neg_logq": torch.full((16,), -float(np.log(100.0)), device=dev)}
    loss = _train_step(lambda pp, bb: rs.twotower_loss(pp, c, bb), p, b)
    with torch.no_grad():
        cand = rs.twotower_item(p, c, torch.arange(100, device=dev))
    red = fit_mpad(cand, MPADConfig(m=16, iters=8), device=dev)
    _, ids = rs.twotower_retrieve(
        p, c, {"user_ids": b["user_ids"][:1], "hist_ids": b["hist_ids"][:1],
               "cand_emb": cand},
        k=5, reducer=(red.matrix, red.mean), rerank=20)
    ok = bool(np.isfinite(loss)) and tuple(ids.shape) == (5,)
    return {"ok": ok, "loss": loss}


_SMOKES = {"sasrec": _sasrec_smoke, "dien": _dien_smoke,
           "autoint": _autoint_smoke, "two-tower-retrieval": _twotower_smoke}


def smoke(name: str, device: DeviceLike = None) -> Dict[str, object]:
    """Arch ``name``'s reduced same-family config: one AdamW train step
    (``make_train_step``) and one serve call, as JAX's ``arch.smoke()``.
    Returns ``{"ok", "loss", ...}``. Runs on ``cuda`` unless ``device``
    names another device."""
    if name not in _SMOKES:
        raise KeyError(f"no recsys arch {name!r}; known: {list(_SMOKES)}")
    return _SMOKES[name](resolve_device(device))


# ================================================================ ArchSpecs

_I32, _F32 = torch.int32, torch.float32


def _shape_defs(table):
    return {k: ShapeDef(name=k, kind=v["kind"], desc=str(v))
            for k, v in table.items()}


def _mk_arch(name, table, init, param_specs, batch_struct, loss_fn,
             serve_fn, batch_specs, out_specs_fn, smoke_name, model_flops,
             retrieval_program=None):
    """The ``ArchSpec`` every recsys builder shares: ``table`` its cells
    (``RECSYS_SHAPES``), ``init(seed, device)`` the parameters,
    ``param_specs(params)`` their specs, ``batch_struct(sname)`` the
    batch's {key: (shape, dtype)}, ``loss_fn(params, batch)`` the train
    loss, ``serve_fn(sname)`` a serve cell's ``fn(params, batch)`` (run on
    the rank's block by ``make_serve_step``), ``retrieval_program(mesh,
    pspec)`` a ``retrieval_cand`` rank program of its own."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.sharding import P
    from repro_torch.parallel.step import make_serve_step, make_sharded_step

    def params_of(device):
        return abstract_tree(lambda: init(0, "cpu"), device)

    def pspec():
        return param_specs(params_of("meta"))

    def abstract_args(sname, device: DeviceLike = "meta"):
        params = params_of(device)
        batch = {k: abstract_tensor(shape, dt, device)
                 for k, (shape, dt) in batch_struct(sname).items()}
        if table[sname]["kind"] == "train":
            return (params, abstract_tree(lambda: init_opt_state(params),
                                          device), batch)
        return (params, batch)

    def arg_specs(sname, mesh):
        ps = pspec()
        if table[sname]["kind"] == "train":
            return (ps, sh.opt_specs(ps), batch_specs(sname, mesh))
        return (ps, batch_specs(sname, mesh))

    def out_specs(sname, mesh):
        ps = pspec()
        if table[sname]["kind"] == "train":
            return (P(), ps, sh.opt_specs(ps))
        return out_specs_fn(sname, mesh)

    def step_fn(sname, mesh):
        ps = pspec()
        if table[sname]["kind"] == "train":
            return make_sharded_step(loss_fn, _ADAM, mesh, ps,
                                     sh.opt_specs(ps))
        if sname == "retrieval_cand" and retrieval_program is not None:
            return retrieval_program(mesh, ps)
        return make_serve_step(serve_fn(sname), mesh, ps)

    return ArchSpec(name=name, family="recsys", shapes=_shape_defs(table),
                    abstract_args=abstract_args, arg_specs=arg_specs,
                    out_specs=out_specs, step_fn=step_fn,
                    smoke=lambda device=None: smoke(smoke_name, device),
                    model_flops=model_flops)


# ---------------------------------------------------------------- SASRec

def make_sasrec_arch(cfg: rs.SASRecConfig,
                     shapes: Optional[dict] = None) -> ArchSpec:
    table = RECSYS_SHAPES if shapes is None else shapes
    from repro_torch.parallel.sharding import P, batch_axes, \
        sasrec_param_specs

    def batch_struct(sname):
        s = table[sname]
        keys = ("seq", "pos", "neg") if s["kind"] == "train" else ("seq",)
        return {k: ((s["batch"], cfg.seq_len), _I32) for k in keys}

    def batch_specs(sname, mesh):
        s = table[sname]
        b_ax = batch_axes(mesh, s["batch"])
        if s["kind"] == "train":
            return {k: P(b_ax, None) for k in ("seq", "pos", "neg")}
        return {"seq": P(b_ax, None)}

    def out_specs_fn(sname, mesh):
        b_ax = batch_axes(mesh, table[sname]["batch"])
        return (P(b_ax, None), P(b_ax, None))

    return _mk_arch(
        "sasrec", table, lambda seed, dev: rs.sasrec_init(cfg, seed, dev),
        sasrec_param_specs, batch_struct,
        lambda p, b: rs.sasrec_loss(p, cfg, b),
        lambda sname: lambda p, b: rs.sasrec_serve_topk(p, cfg, b["seq"],
                                                        k=_TOPK),
        batch_specs, out_specs_fn, "sasrec",
        lambda sname: sasrec_flops(cfg, sname, table))


# ------------------------------------------------------------------ DIEN

def make_dien_arch(cfg: rs.DIENConfig,
                   shapes: Optional[dict] = None) -> ArchSpec:
    table = RECSYS_SHAPES if shapes is None else shapes
    from repro_torch.parallel.sharding import P, batch_axes, \
        dien_param_specs

    def batch_struct(sname):
        s = table[sname]
        b, L = s["batch"], cfg.seq_len
        if s["kind"] == "train":
            return {"hist_items": ((b, L), _I32), "hist_cats": ((b, L), _I32),
                    "target_item": ((b,), _I32), "target_cat": ((b,), _I32),
                    "neg_items": ((b, L), _I32), "neg_cats": ((b, L), _I32),
                    "label": ((b,), _F32)}
        if sname == "retrieval_cand":
            c = s["n_candidates"]
            return {"hist_items": ((1, L), _I32), "hist_cats": ((1, L), _I32),
                    "cand_items": ((c,), _I32), "cand_cats": ((c,), _I32)}
        return {"hist_items": ((b, L), _I32), "hist_cats": ((b, L), _I32),
                "target_item": ((b,), _I32), "target_cat": ((b,), _I32)}

    def batch_specs(sname, mesh):
        s = table[sname]
        if sname == "retrieval_cand":
            allax = tuple(mesh.axis_names)
            return {"hist_items": P(None, None), "hist_cats": P(None, None),
                    "cand_items": P(allax), "cand_cats": P(allax)}
        b_ax = batch_axes(mesh, s["batch"])
        spec = {"hist_items": P(b_ax, None), "hist_cats": P(b_ax, None),
                "target_item": P(b_ax), "target_cat": P(b_ax)}
        if s["kind"] == "train":
            spec.update({"neg_items": P(b_ax, None),
                         "neg_cats": P(b_ax, None), "label": P(b_ax)})
        return spec

    def out_specs_fn(sname, mesh):
        if sname == "retrieval_cand":
            return P(tuple(mesh.axis_names))
        return P(batch_axes(mesh, table[sname]["batch"]))

    def serve_fn(sname):
        if sname == "retrieval_cand":
            return lambda p, b: rs.dien_score(p, cfg, b)
        return lambda p, b: rs.dien_forward(p, cfg, b)[0]

    return _mk_arch(
        "dien", table, lambda seed, dev: rs.dien_init(cfg, seed, dev),
        dien_param_specs, batch_struct,
        lambda p, b: rs.dien_loss(p, cfg, b), serve_fn, batch_specs,
        out_specs_fn, "dien",
        lambda sname: dien_flops(cfg, sname, table))


# --------------------------------------------------------------- AutoInt

def make_autoint_arch(cfg: rs.AutoIntConfig,
                      shapes: Optional[dict] = None) -> ArchSpec:
    table = RECSYS_SHAPES if shapes is None else shapes
    from repro_torch.parallel.sharding import P, batch_axes, \
        autoint_param_specs

    def batch_struct(sname):
        s = table[sname]
        if sname == "retrieval_cand":
            return {"user_fields": ((cfg.n_fields - 1,), _I32),
                    "cand_ids": ((s["n_candidates"],), _I32)}
        spec = {"field_ids": ((s["batch"], cfg.n_fields), _I32)}
        if s["kind"] == "train":
            spec["label"] = ((s["batch"],), _F32)
        return spec

    def batch_specs(sname, mesh):
        s = table[sname]
        if sname == "retrieval_cand":
            return {"user_fields": P(None),
                    "cand_ids": P(tuple(mesh.axis_names))}
        b_ax = batch_axes(mesh, s["batch"])
        spec = {"field_ids": P(b_ax, None)}
        if s["kind"] == "train":
            spec["label"] = P(b_ax)
        return spec

    def out_specs_fn(sname, mesh):
        if sname == "retrieval_cand":
            return P(tuple(mesh.axis_names))
        return P(batch_axes(mesh, table[sname]["batch"]))

    def serve_fn(sname):
        if sname == "retrieval_cand":
            return lambda p, b: rs.autoint_score_candidates(
                p, cfg, b["user_fields"], b["cand_ids"])
        return lambda p, b: rs.autoint_forward(p, cfg, b["field_ids"])

    return _mk_arch(
        "autoint", table, lambda seed, dev: rs.autoint_init(cfg, seed, dev),
        autoint_param_specs, batch_struct,
        lambda p, b: rs.autoint_loss(p, cfg, b), serve_fn, batch_specs,
        out_specs_fn, "autoint",
        lambda sname: autoint_flops(cfg, sname, table))


# ------------------------------------------------------------- Two-tower

def make_twotower_arch(cfg: rs.TwoTowerConfig, mpad_dim: int = 64,
                       rerank: int = 256, mode: str = "mpad",
                       shapes: Optional[dict] = None) -> ArchSpec:
    """``mode`` selects the retrieval_cand serving path, as JAX's:
    full  -- f32 full-dim scan of all candidates
    mpad  -- the paper's technique: the offline-reduced (C, m) cache and a
             re-rank of the top ``rerank``
    int8  -- the int8-quantized reduced cache and the re-rank
    ``shapes`` (default ``RECSYS_SHAPES``) may cut the cells, as every
    builder's.
    """
    table = RECSYS_SHAPES if shapes is None else shapes
    from repro_torch.parallel.sharding import P, batch_axes, \
        twotower_param_specs
    from repro_torch.parallel.step import twotower_retrieval_step

    def batch_struct(sname):
        s = table[sname]
        if sname == "retrieval_cand":
            c = s["n_candidates"]
            base = {"user_ids": ((1,), _I32),
                    "hist_ids": ((1, cfg.n_user_feats), _I32),
                    "cand_emb": ((c, cfg.embed_dim), _F32)}
            if mode == "full":
                return base
            base.update({"red_matrix": ((mpad_dim, cfg.embed_dim), _F32),
                         "red_mean": ((cfg.embed_dim,), _F32)})
            if mode == "int8":
                base.update({"cand_red_q": ((c, mpad_dim), torch.int8),
                             "cand_scale": ((mpad_dim,), _F32)})
            else:
                base["cand_red"] = ((c, mpad_dim), _F32)
            return base
        b = s["batch"]
        spec = {"user_ids": ((b,), _I32),
                "hist_ids": ((b, cfg.n_user_feats), _I32)}
        if s["kind"] == "train":
            spec.update({"pos_items": ((b,), _I32),
                         "neg_items": ((cfg.n_negatives,), _I32),
                         "neg_logq": ((cfg.n_negatives,), _F32)})
        else:
            spec["item_ids"] = ((b,), _I32)
        return spec

    def batch_specs(sname, mesh):
        s = table[sname]
        if sname == "retrieval_cand":
            allax = tuple(mesh.axis_names)
            spec = {"user_ids": P(None), "hist_ids": P(None, None),
                    "cand_emb": P(allax, None)}
            if mode == "full":
                return spec
            spec.update({"red_matrix": P(None, None), "red_mean": P(None)})
            if mode == "int8":
                spec.update({"cand_red_q": P(allax, None),
                             "cand_scale": P(None)})
            else:
                spec["cand_red"] = P(allax, None)
            return spec
        b_ax = batch_axes(mesh, s["batch"])
        spec = {"user_ids": P(b_ax), "hist_ids": P(b_ax, None)}
        if s["kind"] == "train":
            spec.update({"pos_items": P(b_ax), "neg_items": P(None),
                         "neg_logq": P(None)})
        else:
            spec["item_ids"] = P(b_ax)
        return spec

    def out_specs_fn(sname, mesh):
        if sname == "retrieval_cand":
            return (P(None), P(None))
        return P(batch_axes(mesh, table[sname]["batch"]))

    def pairwise(p, batch):
        u = rs.twotower_user(p, cfg, batch["user_ids"], batch["hist_ids"])
        v = rs.twotower_item(p, cfg, batch["item_ids"])
        return torch.sum(u * v, dim=-1)

    return _mk_arch(
        "two-tower-retrieval", table,
        lambda seed, dev: rs.twotower_init(cfg, seed, dev),
        twotower_param_specs, batch_struct,
        lambda p, b: rs.twotower_loss(p, cfg, b), lambda sname: pairwise,
        batch_specs, out_specs_fn, "two-tower-retrieval",
        lambda sname: twotower_flops(cfg, sname, mpad_dim, rerank,
                                     table),
        retrieval_program=lambda mesh, ps: twotower_retrieval_step(
            cfg, mesh, ps, _TOPK, mode, rerank))
