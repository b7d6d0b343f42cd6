"""The recsys family's workload shapes, FLOP counts and smoke steps (port
of the corresponding part of ``repro.configs.recsys_family``) for sasrec,
dien, autoint and two-tower retrieval.

JAX's ``make_*_arch`` builders lower ``ArchSpec``s with ``PartitionSpec``s
for its dry-run tools; they wait with ``configs.common``, the model side's
sharding and the dry-run tools (ROADMAP.md item 13). What the port keeps
of them: ``RECSYS_SHAPES``, each family's ``model_flops`` (``*_flops``
here) and its ``smoke()`` body as ``smoke(name)``: one AdamW train step
and one serve call at a reduced size.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike, cpu_generator, resolve_device
from repro_torch.core import MPADConfig, fit_mpad
from repro_torch.models import recsys as rs
from repro_torch.optim import AdamWConfig, init_opt_state, make_train_step

__all__ = ["RECSYS_SHAPES", "sasrec_flops", "dien_flops", "autoint_flops",
           "twotower_flops", "smoke"]

_ADAM = AdamWConfig(lr=1e-3, total_steps=100_000)

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    # spec says 1,000,000 candidates; padded to 2^20 for even sharding
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=1_048_576),
}

_TOPK = 100


def sasrec_flops(cfg: rs.SASRecConfig, sname: str) -> float:
    s = RECSYS_SHAPES[sname]
    d, L = cfg.embed_dim, cfg.seq_len
    per_ex = cfg.n_blocks * (8 * L * d * d + 4 * L * L * d)
    if s["kind"] == "train":
        return 3.0 * s["batch"] * (per_ex + 4 * L * d)
    scan = 2.0 * cfg.n_items * d      # last-state x catalog
    return s["batch"] * (per_ex + scan)


def dien_flops(cfg: rs.DIENConfig, sname: str) -> float:
    s = RECSYS_SHAPES[sname]
    e2, h, L = cfg.embed_dim * 2, cfg.gru_dim, cfg.seq_len
    gru = 6 * L * (e2 * h + h * h)
    augru = 6 * L * (h * h + h * h) + 2 * L * (h + e2)
    mlp = 2 * ((h + 2 * e2) * 200 + 200 * 80 + 80)
    if s["kind"] == "train":
        return 3.0 * s["batch"] * (gru + augru + mlp)
    n = s.get("n_candidates", s["batch"])
    shared = gru if sname == "retrieval_cand" else n * gru
    return shared + n * (augru + mlp)


def autoint_flops(cfg: rs.AutoIntConfig, sname: str) -> float:
    s = RECSYS_SHAPES[sname]
    f, d_out = cfg.n_fields, cfg.n_heads * cfg.d_attn
    per_ex = cfg.n_attn_layers * (8 * f * cfg.embed_dim * d_out
                                  + 4 * f * f * d_out) + 2 * f * d_out
    n = s.get("n_candidates", s["batch"])
    mult = 3.0 if s["kind"] == "train" else 1.0
    return mult * n * per_ex


def twotower_flops(cfg: rs.TwoTowerConfig, sname: str, mpad_dim: int = 64,
                   rerank: int = 256) -> float:
    s = RECSYS_SHAPES[sname]
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
