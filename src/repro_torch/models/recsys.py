"""RecSys architectures (port of ``repro.models.recsys``): SASRec, DIEN,
AutoInt, two-tower retrieval.

All four share the recsys substrate pattern: huge embedding tables ->
feature interaction -> small MLP. Serving returns top-k only (never a
(B, vocab) score matrix). The two-tower ``twotower_retrieve`` is the
paper's integration point on the model side: candidates are scored in
MPAD-reduced space and re-ranked exactly.

Parameters are dicts and lists of tensors with the JAX pytrees' names and
shapes, so ``bridge.params_from_arrays`` copies a JAX model's parameters
in. The inits draw from a ``torch.Generator`` seeded with ``seed`` on the
target device (not JAX's streams). Where the JAX version scans
(``lax.scan``, ``lax.map``), the port loops in Python: DIEN's GRU steps
over time, and the candidate chunks of ``dien_score`` (a batch dimension
in place of the ``vmap``) and ``autoint_score_candidates``. Every top-k
keeps ``lax.top_k``'s order: the lower index first among equal scores.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device

from .embedding import embedding_bag, embedding_lookup
from .layers import he_init
from .moe import top_k

__all__ = [
    "SASRecConfig", "sasrec_init", "sasrec_forward", "sasrec_loss",
    "sasrec_serve_topk",
    "DIENConfig", "dien_init", "dien_forward", "dien_loss", "dien_score",
    "AutoIntConfig", "autoint_init", "autoint_forward", "autoint_loss",
    "TwoTowerConfig", "twotower_init", "twotower_user", "twotower_item",
    "twotower_loss", "twotower_retrieve", "reduced_scores",
]

Params = Dict[str, Any]

# dien_score's candidates a batch (JAX's lax.map batch_size)
DIEN_SCORE_CHUNK = 4096


def _generator(seed: int, device: DeviceLike) -> torch.Generator:
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))


def _zeros(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def _mlp_init(gen, dims, dtype):
    return [{"w": he_init(gen, (dims[i], dims[i + 1]), dims[i], dtype),
             "b": _zeros(gen, (dims[i + 1],), dtype)}
            for i in range(len(dims) - 1)]


def _mlp_apply(layers, x, final_act=False):
    for i, lp in enumerate(layers):
        x = x @ lp["w"] + lp["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


# ================================================================ SASRec

@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 100_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dropout: float = 0.0
    dtype: torch.dtype = torch.float32


def sasrec_init(cfg: SASRecConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random SASRec parameters. Runs on ``cuda`` unless ``device`` names
    another device (as every init of this module)."""
    gen = _generator(seed, device)
    d, dt = cfg.embed_dim, cfg.dtype
    p = {"item_emb": he_init(gen, (cfg.n_items, d), d, dt),
         "pos_emb": he_init(gen, (cfg.seq_len, d), d, dt),
         "blocks": []}
    for _ in range(cfg.n_blocks):
        p["blocks"].append({
            "ln1": torch.ones((d,), dtype=dt, device=gen.device),
            "ln2": torch.ones((d,), dtype=dt, device=gen.device),
            "wq": he_init(gen, (d, d), d, dt),
            "wk": he_init(gen, (d, d), d, dt),
            "wv": he_init(gen, (d, d), d, dt),
            "w1": he_init(gen, (d, d), d, dt),
            "b1": _zeros(gen, (d,), dt),
            "w2": he_init(gen, (d, d), d, dt),
            "b2": _zeros(gen, (d,), dt),
        })
    p["final_ln"] = torch.ones((d,), dtype=dt, device=gen.device)
    return p


def _ln(x, g):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g


def sasrec_forward(params: Params, cfg: SASRecConfig,
                   seq: torch.Tensor) -> torch.Tensor:
    """seq (B, L) item ids (-1 pad). Returns hidden states (B, L, D)."""
    b, l = seq.shape
    h = embedding_lookup(params["item_emb"], seq) * torch.sqrt(
        torch.tensor(cfg.embed_dim, dtype=cfg.dtype))
    h = h + params["pos_emb"][None, :l]
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=seq.device))
    valid = seq >= 0
    nh, dh = cfg.n_heads, cfg.embed_dim // cfg.n_heads
    mask = causal[None, None] & valid[:, None, None, :]
    for blk in params["blocks"]:
        x = _ln(h, blk["ln1"])
        q = (x @ blk["wq"]).reshape(b, l, nh, dh)
        k = (x @ blk["wk"]).reshape(b, l, nh, dh)
        v = (x @ blk["wv"]).reshape(b, l, nh, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        s = torch.where(mask, s, -1e30)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, l,
                                                           cfg.embed_dim)
        h = h + o
        x2 = _ln(h, blk["ln2"])
        h = h + torch.relu(x2 @ blk["w1"] + blk["b1"]) @ blk["w2"] \
            + blk["b2"]
    return _ln(h, params["final_ln"]) * valid[..., None]


def sasrec_loss(params: Params, cfg: SASRecConfig,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Paper objective: BCE(h_t . e_pos) vs BCE(h_t . e_neg)."""
    h = sasrec_forward(params, cfg, batch["seq"])          # (B, L, D)
    epos = embedding_lookup(params["item_emb"], batch["pos"])
    eneg = embedding_lookup(params["item_emb"], batch["neg"])
    sp = torch.sum(h * epos, -1).float()
    sn = torch.sum(h * eneg, -1).float()
    mask = (batch["pos"] >= 0).float()
    loss = (F.softplus(-sp) + F.softplus(sn)) * mask
    return torch.sum(loss) / torch.clamp_min(torch.sum(mask), 1.0)


@torch.no_grad()
def sasrec_serve_topk(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
                      k: int = 100, item_chunk: int = 8192
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score all items for the last position; blocked running top-k so the
    (B, V) score matrix is never materialized. ``item_chunk`` shrinks to
    its gcd with the catalog when it does not divide it. Returns (scores
    (B, k), item ids (B, k) int64)."""
    h = sasrec_forward(params, cfg, seq)[:, -1]            # (B, D)
    v = params["item_emb"].shape[0]
    item_chunk = min(item_chunk, v)
    if v % item_chunk:
        item_chunk = math.gcd(item_chunk, v)
    best_s = torch.full((h.shape[0], k), -torch.inf, dtype=h.dtype,
                        device=h.device)
    best_i = torch.zeros((h.shape[0], k), dtype=torch.int64, device=h.device)
    ids = torch.arange(item_chunk, device=h.device)
    for off in range(0, v, item_chunk):
        s = h @ params["item_emb"][off:off + item_chunk].T  # (B, chunk)
        cs = torch.cat([best_s, s], dim=1)
        ci = torch.cat([best_i, (off + ids)[None].expand_as(s)], dim=1)
        best_s, sel = top_k(cs, k)
        best_i = torch.gather(ci, 1, sel)
    return best_s, best_i


# ================================================================== DIEN

@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    n_items: int = 1_000_000
    n_cats: int = 10_000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: Tuple[int, ...] = (200, 80)
    aux_weight: float = 0.5
    dtype: torch.dtype = torch.float32


def _gru_init(gen, d_in, d_h, dtype):
    return {"wx": he_init(gen, (d_in, 3 * d_h), d_in, dtype),
            "wh": he_init(gen, (d_h, 3 * d_h), d_h, dtype),
            "b": _zeros(gen, (3 * d_h,), dtype)}


def _gru_cell_pre(p, h, xproj, d_h):
    """GRU step from a pre-projected input (xproj = x @ wx + b). xproj may
    hold one row for a batch of states (it broadcasts)."""
    zs = xproj[..., :2 * d_h] + h @ p["wh"][:, :2 * d_h]
    r = torch.sigmoid(zs[..., :d_h])
    z = torch.sigmoid(zs[..., d_h:])
    # the candidate uses the reset gate on the hidden contribution
    cand = torch.tanh(xproj[..., 2 * d_h:] + (r * h) @ p["wh"][:, 2 * d_h:])
    return (1.0 - z) * cand + z * h


def _gru_cell(p, h, x, d_h):
    return _gru_cell_pre(p, h, x @ p["wx"] + p["b"], d_h)


def dien_init(cfg: DIENConfig, seed: int = 0,
              device: DeviceLike = None) -> Params:
    gen = _generator(seed, device)
    e2, dt = cfg.embed_dim * 2, cfg.dtype                  # item + category
    return {
        "item_emb": he_init(gen, (cfg.n_items, cfg.embed_dim),
                            cfg.embed_dim, dt),
        "cat_emb": he_init(gen, (cfg.n_cats, cfg.embed_dim),
                           cfg.embed_dim, dt),
        "gru1": _gru_init(gen, e2, cfg.gru_dim, dt),
        "att_w": he_init(gen, (cfg.gru_dim + e2, 1), cfg.gru_dim, dt),
        "att_proj": he_init(gen, (e2, cfg.gru_dim), e2, dt),
        "gru2": _gru_init(gen, cfg.gru_dim, cfg.gru_dim, dt),
        "mlp": _mlp_init(gen, (cfg.gru_dim + e2 + e2,) + tuple(cfg.mlp_dims)
                         + (1,), dt),
        "aux_w": he_init(gen, (cfg.gru_dim, e2), cfg.gru_dim, dt),
    }


def _hist_embed(params, batch):
    hi = embedding_lookup(params["item_emb"], batch["hist_items"])
    hc = embedding_lookup(params["cat_emb"], batch["hist_cats"])
    return torch.cat([hi, hc], dim=-1)                     # (B, L, 2E)


def _target_embed(params, items, cats):
    ti = embedding_lookup(params["item_emb"], items)
    tc = embedding_lookup(params["cat_emb"], cats)
    return torch.cat([ti, tc], dim=-1)                     # (..., 2E)


def dien_interest(params: Params, cfg: DIENConfig,
                  hist: torch.Tensor) -> torch.Tensor:
    """GRU-1 over the history -> interest states (B, L, H). Target
    independent; the time steps run in a Python loop."""
    h = hist.new_zeros((hist.shape[0], cfg.gru_dim))
    states = []
    for t in range(hist.shape[1]):
        h = _gru_cell(params["gru1"], h, hist[:, t], cfg.gru_dim)
        states.append(h)
    return torch.stack(states, dim=1)


def dien_augru(params: Params, cfg: DIENConfig, states: torch.Tensor,
               target: torch.Tensor, hist_mask: torch.Tensor) -> torch.Tensor:
    """Attention-gated GRU (AUGRU) over the interest states, one target a
    row: target (B, 2E); states (B, L, H), or (1, L, H) shared by every
    target (``dien_score``), as is hist_mask (B or 1, L). Returns (B, H).

    The attention logit ``[states, target] @ att_w`` is formed as its two
    halves (states @ att_w[:H] + target @ att_w[H:]), and GRU-2's input
    projection (states @ wx + b) is formed once before the time loop, so
    shared states are neither copied nor projected once a target."""
    hd = cfg.gru_dim
    proj_t = target @ params["att_proj"]                   # (B, H)
    scores = (states @ params["att_w"][:hd])[..., 0] \
        + (target @ params["att_w"][hd:])                  # (B, L)
    if states.shape[0] == target.shape[0]:
        scores = scores + torch.matmul(states, proj_t[..., None])[..., 0]
    else:
        scores = scores + proj_t @ states[0].T
    scores = torch.where(hist_mask, scores, -1e30)
    att = torch.softmax(scores.float(), dim=-1).to(states.dtype)
    xproj = states @ params["gru2"]["wx"] + params["gru2"]["b"]
    h = target.new_zeros((target.shape[0], hd))
    for t in range(states.shape[1]):
        h_new = _gru_cell_pre(params["gru2"], h, xproj[:, t], hd)
        a_t = att[:, t, None]
        h = (1.0 - a_t) * h + a_t * h_new                  # attention gate
    return h


def dien_forward(params: Params, cfg: DIENConfig,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logit (B,), interest states) for the target item/cat."""
    hist = _hist_embed(params, batch)
    mask = batch["hist_items"] >= 0
    states = dien_interest(params, cfg, hist)
    target = _target_embed(params, batch["target_item"], batch["target_cat"])
    ht = dien_augru(params, cfg, states, target, mask)
    feats = torch.cat([ht, target, torch.sum(hist * mask[..., None], 1)],
                      dim=-1)
    return _mlp_apply(params["mlp"], feats)[..., 0], states


def dien_loss(params: Params, cfg: DIENConfig,
              batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logit, states = dien_forward(params, cfg, batch)
    bce = torch.mean(F.softplus(-logit) * batch["label"]
                     + F.softplus(logit) * (1.0 - batch["label"]))
    # DIEN's auxiliary loss: h_t should predict behaviour e_{t+1} over
    # negatives
    hist = _hist_embed(params, batch)
    neg = _target_embed(params, batch["neg_items"], batch["neg_cats"])
    proj = states[:, :-1] @ params["aux_w"]                # (B, L-1, 2E)
    sp = torch.sum(proj * hist[:, 1:], -1).float()
    sn = torch.sum(proj * neg[:, 1:], -1).float()
    m = (batch["hist_items"][:, 1:] >= 0).float()
    aux = torch.sum((F.softplus(-sp) + F.softplus(sn)) * m) / \
        torch.clamp_min(torch.sum(m), 1.0)
    return bce + cfg.aux_weight * aux


@torch.no_grad()
def dien_score(params: Params, cfg: DIENConfig,
               batch: Dict[str, torch.Tensor],
               chunk: int = DIEN_SCORE_CHUNK) -> torch.Tensor:
    """Bulk scoring: one user history against C candidate targets.

    batch: hist_items / hist_cats (1, L); cand_items / cand_cats (C,). One
    GRU-1 pass serves every candidate; the AUGRU runs over ``chunk``
    candidates at a time as a batch. Returns (C,) logits."""
    hist = _hist_embed(params, batch)
    mask = batch["hist_items"] >= 0
    states = dien_interest(params, cfg, hist)              # (1, L, H)
    pooled = torch.sum(hist * mask[..., None], 1)          # (1, 2E)
    out = []
    for c0 in range(0, batch["cand_items"].shape[0], chunk):
        tgt = _target_embed(params, batch["cand_items"][c0:c0 + chunk],
                            batch["cand_cats"][c0:c0 + chunk])
        ht = dien_augru(params, cfg, states, tgt, mask)
        feats = torch.cat([ht, tgt, pooled.expand(tgt.shape[0], -1)],
                          dim=-1)
        out.append(_mlp_apply(params["mlp"], feats)[:, 0])
    return torch.cat(out)


# ================================================================ AutoInt

@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_fields: int = 39
    vocab_per_field: int = 100_000
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    dtype: torch.dtype = torch.float32


def autoint_init(cfg: AutoIntConfig, seed: int = 0,
                 device: DeviceLike = None) -> Params:
    gen = _generator(seed, device)
    dt = cfg.dtype
    p = {"emb": he_init(gen, (cfg.n_fields * cfg.vocab_per_field,
                              cfg.embed_dim), cfg.embed_dim, dt),
         "layers": []}
    d_out = cfg.n_heads * cfg.d_attn
    d = cfg.embed_dim
    for _ in range(cfg.n_attn_layers):
        p["layers"].append({name: he_init(gen, (d, d_out), d, dt)
                            for name in ("wq", "wk", "wv", "wres")})
        d = d_out
    p["head"] = he_init(gen, (cfg.n_fields * d, 1), cfg.n_fields * d, dt)
    return p


def autoint_forward(params: Params, cfg: AutoIntConfig,
                    field_ids: torch.Tensor) -> torch.Tensor:
    """field_ids (B, n_fields) local-per-field ids -> logit (B,)."""
    offs = torch.arange(cfg.n_fields, device=field_ids.device) \
        * cfg.vocab_per_field
    h = embedding_lookup(params["emb"], field_ids + offs[None, :])  # (B,F,E)
    nh, da = cfg.n_heads, cfg.d_attn
    for lp in params["layers"]:
        b, f, _ = h.shape
        q = (h @ lp["wq"]).reshape(b, f, nh, da)
        k = (h @ lp["wk"]).reshape(b, f, nh, da)
        v = (h @ lp["wv"]).reshape(b, f, nh, da)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(da)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, f, nh * da)
        h = torch.relu(o + h @ lp["wres"])
    return (h.reshape(h.shape[0], -1) @ params["head"])[..., 0]


def autoint_loss(params: Params, cfg: AutoIntConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logit = autoint_forward(params, cfg, batch["field_ids"]).float()
    y = batch["label"]
    return torch.mean(F.softplus(-logit) * y + F.softplus(logit) * (1 - y))


@torch.no_grad()
def autoint_score_candidates(params: Params, cfg: AutoIntConfig,
                             user_fields: torch.Tensor,
                             cand_ids: torch.Tensor,
                             chunk: int = 8192) -> torch.Tensor:
    """Retrieval scoring: a fixed user context (n_fields - 1,) against C
    candidate ids in field 0, evaluated ``chunk`` candidates at a time
    (``chunk`` must divide C once cut to C, as JAX's reshape needs)."""
    c = cand_ids.shape[0]
    chunk = min(chunk, c)
    if c % chunk:
        raise ValueError(f"chunk {chunk} does not divide {c} candidates")
    out = []
    for c0 in range(0, c, chunk):
        ids = cand_ids[c0:c0 + chunk]
        rows = torch.cat([ids[:, None], user_fields[None, :].expand(
            ids.shape[0], cfg.n_fields - 1).to(ids.dtype)], dim=1)
        out.append(autoint_forward(params, cfg, rows))
    return torch.cat(out)


# ============================================================== Two-tower

@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two_tower"
    n_users: int = 5_000_000
    n_items: int = 2_000_000
    n_user_feats: int = 8                  # multi-hot history bag width
    field_dim: int = 64
    embed_dim: int = 256
    tower_dims: Tuple[int, ...] = (1024, 512, 256)
    n_negatives: int = 8192
    temperature: float = 0.05
    dtype: torch.dtype = torch.float32


def twotower_init(cfg: TwoTowerConfig, seed: int = 0,
                  device: DeviceLike = None) -> Params:
    gen = _generator(seed, device)
    dt = cfg.dtype
    return {
        "user_emb": he_init(gen, (cfg.n_users, cfg.field_dim),
                            cfg.field_dim, dt),
        "item_emb": he_init(gen, (cfg.n_items, cfg.field_dim),
                            cfg.field_dim, dt),
        "user_mlp": _mlp_init(gen, (cfg.field_dim * 2,)
                              + tuple(cfg.tower_dims), dt),
        "item_mlp": _mlp_init(gen, (cfg.field_dim,) + tuple(cfg.tower_dims),
                              dt),
    }


def _normalize(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True), 1e-6)


def twotower_user(params: Params, cfg: TwoTowerConfig,
                  user_ids: torch.Tensor,
                  hist_ids: torch.Tensor) -> torch.Tensor:
    """user_ids (B,), hist_ids (B, n_user_feats) -> normalized (B, D)."""
    uid = embedding_lookup(params["user_emb"], user_ids)
    # the history bag reads the item table, in the user field's width
    bag = embedding_bag(params["item_emb"], hist_ids, mode="mean")
    u = _mlp_apply(params["user_mlp"], torch.cat([uid, bag], dim=-1))
    return _normalize(u)


def twotower_item(params: Params, cfg: TwoTowerConfig,
                  item_ids: torch.Tensor) -> torch.Tensor:
    it = embedding_lookup(params["item_emb"], item_ids)
    return _normalize(_mlp_apply(params["item_mlp"], it))


def twotower_loss(params: Params, cfg: TwoTowerConfig,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sampled softmax with logQ correction (Yi et al., RecSys'19).

    batch: user_ids (B,), hist_ids (B, F), pos_items (B,),
    neg_items (N_neg,), neg_logq (N_neg,) log sampling probabilities."""
    u = twotower_user(params, cfg, batch["user_ids"], batch["hist_ids"])
    vp = twotower_item(params, cfg, batch["pos_items"])    # (B, D)
    vn = twotower_item(params, cfg, batch["neg_items"])    # (N, D)
    sp = torch.sum(u * vp, -1) / cfg.temperature           # (B,)
    sn = (u @ vn.T) / cfg.temperature - batch["neg_logq"][None, :]
    logits = torch.cat([sp[:, None], sn], dim=1).float()
    return torch.mean(torch.logsumexp(logits, dim=1) - logits[:, 0])


@torch.no_grad()
def twotower_retrieve(params: Params, cfg: TwoTowerConfig,
                      batch: Dict[str, torch.Tensor], k: int = 100,
                      reducer=None, rerank: int = 0,
                      quantized: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Retrieval scoring: one query against (C, D) candidate embeddings
    ``batch["cand_emb"]``. Returns (scores (k,), candidate ids (k,)).

    ``reducer``: an optional (matrix (m, D), mean (D,)) MPAD projection,
    the paper's technique on the candidate cache: score in m dims, then
    exactly re-rank the top ``max(k, rerank)`` in full dims. The reduced
    cache is ``batch["cand_red"]`` when given, else reduced here.

    ``quantized``: the reduced cache as int8 with per-dim scales
    (``batch["cand_red_q"]``, ``batch["cand_scale"]``, from
    ``quantize_candidates``). JAX scores it as a bf16 x bf16 product with
    f32 accumulation; here the same bf16-rounded operands (the int8 codes
    are exact in bf16) meet in an f32 matmul, where each product is exact
    and the sums round in f32 as JAX's do."""
    u = twotower_user(params, cfg, batch["user_ids"], batch["hist_ids"])
    cand = batch["cand_emb"]                               # (C, D)
    if reducer is None:
        s, ids = top_k((u @ cand.T)[0], k)
        return s, ids
    scores_r = reduced_scores(u, batch, reducer, quantized)
    _, pre = top_k(scores_r, max(k, rerank))
    full = (u @ cand[pre].T)[0]                            # exact re-rank
    s, loc = top_k(full, k)
    return s, pre[loc]


def reduced_scores(u: torch.Tensor, batch: Dict[str, torch.Tensor],
                   reducer, quantized: bool = False) -> torch.Tensor:
    """``twotower_retrieve``'s first stage: the query (1, D) scored
    against every candidate of ``batch`` in the reduced space of
    ``reducer`` (matrix, mean): the (C,) reduced scores, from the int8
    cache when ``quantized``, else from ``cand_red`` (or ``cand_emb``
    reduced here)."""
    mat, mean = reducer
    ur = (u - mean) @ mat.T                                # (1, m)
    if quantized:
        cq, scale = batch["cand_red_q"], batch["cand_scale"]
        a = (ur * scale[None, :]).to(torch.bfloat16).float()
        return (a @ cq.float().T)[0]                       # (C,)
    cr = batch.get("cand_red")
    if cr is None:
        cr = (batch["cand_emb"] - mean) @ mat.T
    return (ur @ cr.T)[0]                                  # reduced space


def quantize_candidates(cand_red: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline int8 quantization of the reduced candidate cache (symmetric,
    per-dim scales; round half to even, clipped to +-127). Returns (int8
    (C, m), scales (m,)), bit-equal on every device to JAX's (called
    eagerly). The divisor 127 is a tensor: PyTorch on CUDA divides by a
    Python scalar as a multiply by its reciprocal, which rounds otherwise
    on 5% of inputs."""
    amax = torch.amax(torch.abs(cand_red), dim=0)
    scale = amax / torch.full_like(amax, 127.0) + 1e-8
    q = torch.clamp(torch.round(cand_red / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale
