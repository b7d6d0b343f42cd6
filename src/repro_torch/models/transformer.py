"""Decoder-only LM (port of ``repro.models.transformer``): dense and MoE
configurations, the training loss, prefill, decode and the embedding hook.

The structure is the JAX package's:

* **Run-structured layer stack.** Layers are grouped into contiguous runs
  of one attention kind ("global" full-causal or "local" sliding-window);
  each run's parameters are stacked along a leading (length,) axis. A
  Python loop over the layers stands in for the ``lax.scan``. Local runs
  carry window-sized ring-buffer KV caches, global runs full-length ones.
* **Position-based masking**: causality, sliding windows and ring-buffer
  cache validity are all expressed through absolute positions, so prefill
  and decode share one attention code path (``layers.chunked_attention``).
* ``attn_impl="flash"`` routes self-attention (training, prefill,
  embedding) to kernel K5 through
  ``kernels.flash_attention.flash_attention``, whose backward recomputes
  through the chunked path; decode attends over the cache through
  ``chunked_attention``, as in JAX.
* **Chunked cross-entropy**: ``lm_loss`` runs the head and the CE per
  sequence chunk of ``seq_chunk`` tokens through ``kernels.fused_ce``
  (kernel K6 on the card), so neither the (B, S, vocab) logits nor a
  chunk's (B * seq_chunk, vocab) logits are ever materialized.
* **Remat**: with ``remat`` set and grad enabled, each layer runs under
  ``torch.utils.checkpoint`` (the port of ``jax.checkpoint``): the
  backward keeps only each layer's input and recomputes the rest.
* **MoE**: with ``cfg.moe`` set, each layer's MLP is ``moe.moe_block``
  (parameters under the run's ``"moe"`` key); the training forward sums
  the layers' router aux losses and ``lm_loss`` adds
  ``router_aux_weight * aux / n_layers``. Prefill and decode drop the aux
  loss. Which MoE implementation runs is ``cfg.moe.impl``:
  ``configs.lm_family.shape_config`` gives decode the ``dense`` one, as
  the JAX package's ``make_lm_arch`` does. Under an active mesh (the
  sharded train step, ``parallel.step``) ``impl="ep"`` runs expert
  parallelism on the rank's rows and its blocks of the MoE parameters
  (``moe.moe_block``), and the aux loss is the mean over every rank.

Parameters are a dict of tensors with the JAX pytree's names and shapes
(``{"embed", "final_norm", "runs": [per-run dict of (length, ...) stacks],
"lm_head"?}``), so ``bridge.lm_params_from_arrays`` is a copy. Unlike JAX,
``lm_prefill`` and ``lm_decode_step`` update the cache in place (and
return it), and run under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_ce import fused_ce

from .layers import chunked_attention, he_init, rms_norm, rope, swiglu
from .moe import MoEConfig, init_moe_params, moe_block

__all__ = ["LMConfig", "lm_init_params", "lm_loss", "lm_train_forward",
           "lm_prefill", "lm_decode_step", "init_cache", "lm_embed",
           "layer_runs"]

_NEG_INF = -1e30

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The JAX ``LMConfig``, field for field. ``dtype`` is a torch dtype.
    ``moe`` (a ``moe.MoEConfig``) makes every layer's MLP a mixture of
    experts. ``seq_chunk`` is the sequence chunk of ``lm_loss``'s
    cross-entropy; ``remat`` checkpoints each layer of the training forward (it changes
    nothing when grad is disabled, as in serving)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None   # gemma3: 10k local / 1M global
    sliding_window: Optional[int] = None   # window for "local" layers
    global_every: Optional[int] = None     # every k-th layer global (gemma 5:1 -> 6)
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.float32
    seq_chunk: int = 1024                  # chunked-CE sequence chunk
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    attn_impl: str = "chunked"             # chunked | flash (kernel K5)

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 255) // 256) * 256


def _check_attn_impl(cfg: LMConfig):
    if cfg.attn_impl not in ("chunked", "flash"):
        raise ValueError(f"attn_impl must be 'chunked' or 'flash', got "
                         f"{cfg.attn_impl!r}")


def layer_runs(cfg: LMConfig) -> List[Tuple[str, int]]:
    """[(kind, length), ...] contiguous runs of same-kind layers."""
    if cfg.global_every is None:
        kind = "local" if cfg.sliding_window is not None else "global"
        return [(kind, cfg.n_layers)]
    kinds = ["global" if (i % cfg.global_every) == cfg.global_every - 1
             else "local" for i in range(cfg.n_layers)]
    runs: List[Tuple[str, int]] = []
    for k in kinds:
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1] + 1)
        else:
            runs.append((k, 1))
    return runs


def _init_run_params(gen: torch.Generator, cfg: LMConfig, length: int):
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)
    dt, dev = cfg.dtype, gen.device
    p = {
        "ln1": torch.zeros((length, d), dtype=dt, device=dev),
        "ln2": torch.zeros((length, d), dtype=dt, device=dev),
        "wq": he_init(gen, (length, d, h * dh), d, dt),
        "wk": he_init(gen, (length, d, kv * dh), d, dt),
        "wv": he_init(gen, (length, d, kv * dh), d, dt),
        "wo": he_init(gen, (length, h * dh, d), h * dh, dt),
    }
    if cfg.moe is None:
        p.update({
            "w_gate": he_init(gen, (length, d, f), d, dt),
            "w_up": he_init(gen, (length, d, f), d, dt),
            "w_down": he_init(gen, (length, f, d), f, dt),
        })
    else:
        p["moe"] = init_moe_params(gen, cfg.moe, d, length, dt)
    return p


def lm_init_params(cfg: LMConfig, seed: int,
                   device: DeviceLike = None) -> Params:
    """Random parameters in the JAX pytree's layout, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device (the
    same seed gives the same weights on one device type; the CPU and CUDA
    streams differ, and neither is JAX's). Runs on ``cuda`` unless
    ``device`` names another device."""
    _check_attn_impl(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = {
        "embed": he_init(gen, (cfg.vocab_padded, cfg.d_model), cfg.d_model,
                         cfg.dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                  device=dev),
        "runs": [_init_run_params(gen, cfg, length)
                 for _, length in layer_runs(cfg)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = he_init(gen, (cfg.d_model, cfg.vocab_padded),
                                    cfg.d_model, cfg.dtype)
    return params


# ------------------------------------------------------------- layer bodies

def _qkv(cfg: LMConfig, x, lp, q_pos, window):
    b, sq, _ = x.shape
    theta = (cfg.rope_theta_local
             if (window is not None and cfg.rope_theta_local)
             else cfg.rope_theta)
    q = (x @ lp["wq"]).reshape(b, sq, cfg.n_heads, cfg.d_head)
    k = (x @ lp["wk"]).reshape(b, sq, cfg.n_kv_heads, cfg.d_head)
    v = (x @ lp["wv"]).reshape(b, sq, cfg.n_kv_heads, cfg.d_head)
    return rope(q, q_pos, theta), rope(k, q_pos, theta), v


def _mlp(cfg: LMConfig, h, lp):
    """The MLP sublayer: (h_out, aux loss (f32 scalar, 0 when dense))."""
    x2 = rms_norm(h, lp["ln2"])
    if cfg.moe is None:
        return (h + swiglu(x2, lp["w_gate"], lp["w_up"], lp["w_down"]),
                torch.zeros((), dtype=torch.float32, device=h.device))
    y, aux = moe_block(x2, lp["moe"], cfg.moe)
    return h + y, aux


def _layer_self(cfg: LMConfig, window, h, lp, q_pos):
    """Self-contained segment attention (training, prefill, embedding).

    Returns (h_out, k, v, aux)."""
    b, sq, _ = h.shape
    q, k, v = _qkv(cfg, rms_norm(h, lp["ln1"]), lp, q_pos, window)
    if cfg.attn_impl == "flash":
        attn = flash_attention(q, k, v, window)
    else:
        attn = chunked_attention(q, k, v, q_pos, q_pos, window=window,
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    h = h + attn.reshape(b, sq, -1) @ lp["wo"]
    h, aux = _mlp(cfg, h, lp)
    return h, k, v, aux


def _layer_cached(cfg: LMConfig, window, h, lp, q_pos, ck, cv, kv_pos,
                  slots):
    """Decode: write this step's K/V into cache slots ``slots`` (in place),
    attend over the cache. Returns h_out."""
    b, sq, _ = h.shape
    q, k, v = _qkv(cfg, rms_norm(h, lp["ln1"]), lp, q_pos, window)
    ck[:, slots] = k.to(ck.dtype)
    cv[:, slots] = v.to(cv.dtype)
    attn = chunked_attention(
        q, ck.to(q.dtype), cv.to(q.dtype), q_pos, kv_pos, window=window,
        q_chunk=cfg.q_chunk, kv_chunk=ck.shape[1])
    h = h + attn.reshape(b, sq, -1) @ lp["wo"]
    return _mlp(cfg, h, lp)[0]


def _layers(run: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A run's (length, ...) stacks as one parameter dict per layer (the
    ``"moe"`` sub-dict likewise). One ``unbind`` per stack, so the
    backward builds each stacked gradient once (indexing layer by layer
    would write a full-size zero gradient per layer)."""
    keys = list(run)
    per_key = [_layers(run[key]) if isinstance(run[key], dict)
               else run[key].unbind(0) for key in keys]
    return [dict(zip(keys, per_layer)) for per_layer in zip(*per_key)]


def _window(cfg: LMConfig, kind: str) -> Optional[int]:
    return cfg.sliding_window if kind == "local" else None


def _forward_no_cache(cfg: LMConfig, params, h, q_pos):
    """Training / embedding forward over all runs; no cache. With
    ``cfg.remat`` and grad enabled, each layer is checkpointed. Returns
    (h, the sum of the layers' aux losses)."""
    remat = cfg.remat and torch.is_grad_enabled()
    total_aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for ri, (kind, _) in enumerate(layer_runs(cfg)):
        window = _window(cfg, kind)

        def body(h, lp, _w=window):
            h, _, _, aux = _layer_self(cfg, _w, h, lp, q_pos)
            return h, aux

        run_aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for lp in _layers(params["runs"][ri]):
            # the layer draws no random numbers: no RNG state to replay
            h, aux = (checkpoint(body, h, lp, use_reentrant=False,
                                 preserve_rng_state=False) if remat
                      else body(h, lp))
            run_aux = run_aux + aux
        total_aux = total_aux + run_aux
    return h, total_aux


def _final_hidden(cfg: LMConfig, params, tokens):
    """The final-normed hidden states (B, S, d_model) of ``tokens``, and
    the layers' summed aux loss."""
    h = params["embed"][tokens].to(cfg.dtype)
    h, aux = _forward_no_cache(
        cfg, params, h, torch.arange(tokens.shape[1], device=tokens.device))
    return rms_norm(h, params["final_norm"]), aux


def _head(cfg: LMConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits_head(cfg: LMConfig, params, h):
    """Serving logits (the loss never forms them: it goes through
    ``fused_ce``), so the padded tail is masked in place."""
    logits = h @ _head(cfg, params)
    if cfg.vocab_padded != cfg.vocab:       # mask the padded vocab tail
        logits[..., cfg.vocab:] = _NEG_INF
    return logits


def lm_loss(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over the (B, S) tokens, with chunked
    (never materialized) logits: each chunk of ``seq_chunk`` positions
    (the gcd with S when it does not divide S) of every sequence goes
    through ``fused_ce`` over the head with the padded vocab masked. The
    per-token losses are summed and divided by B * S. Differentiable in
    ``params``; where JAX rounds the logits to ``cfg.dtype`` before the
    f32 CE, K6 forms them in f32 from the same inputs. An MoE
    configuration adds ``router_aux_weight * aux / n_layers``, aux the sum
    of the layers' Switch losses."""
    _check_attn_impl(cfg)
    b, s = tokens.shape
    h, aux = _final_hidden(cfg, params, tokens)
    ck = min(cfg.seq_chunk, s)
    if s % ck:
        ck = math.gcd(ck, s)
    head = _head(cfg, params)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, ck):
        hc = h[:, c0:c0 + ck].reshape(-1, cfg.d_model)
        total = total + fused_ce(hc, head, labels[:, c0:c0 + ck].reshape(-1),
                                 cfg.vocab).sum()
    loss = total / (b * s)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
    return loss


def lm_train_forward(params: Params, cfg: LMConfig,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``lm_loss`` on a ``{"tokens", "labels"}`` batch."""
    return lm_loss(params, cfg, batch["tokens"], batch["labels"])


# ------------------------------------------------------- serving path

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Cache:
    """Per-run KV caches: local runs allocate only the sliding window.
    ``pos`` holds each slot's absolute position, -1 while unwritten. Runs
    on ``cuda`` unless ``device`` names another device."""
    dev = resolve_device(device)
    dtype = dtype if dtype is not None else cfg.dtype
    cache = []
    for kind, length in layer_runs(cfg):
        s_run = (min(cfg.sliding_window, max_len)
                 if kind == "local" and cfg.sliding_window else max_len)
        shape = (length, batch, s_run, cfg.n_kv_heads, cfg.d_head)
        cache.append({
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.full((s_run,), -1, dtype=torch.int32, device=dev),
        })
    return cache


@torch.inference_mode()
def lm_prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor,
               cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """Process a full prompt (B, S); returns (last-position logits
    (B, vocab_padded), cache).

    Attention is self-contained within the prompt. The caches are written
    in place: local runs keep only the last ``window`` positions in their
    ring buffers (positions s - n_write .. s-1 go to slots pos % s_run)."""
    _check_attn_impl(cfg)
    b, s = tokens.shape
    dev = tokens.device
    h = params["embed"][tokens].to(cfg.dtype)
    q_pos = torch.arange(s, device=dev)
    for ri, (kind, _) in enumerate(layer_runs(cfg)):
        rc = cache[ri]
        s_run = rc["k"].shape[2]
        n_write = min(s, s_run)
        src = torch.arange(s - n_write, s, device=dev)   # positions written
        dst = src % s_run                   # ring slots (identity if s <= s_run)
        for i, lp in enumerate(_layers(params["runs"][ri])):
            h, k, v, _ = _layer_self(cfg, _window(cfg, kind), h, lp, q_pos)
            rc["k"][i][:, dst] = k[:, src].to(rc["k"].dtype)
            rc["v"][i][:, dst] = v[:, src].to(rc["v"].dtype)
        rc["pos"][dst] = src.to(torch.int32)
    h = rms_norm(h, params["final_norm"])
    logits = _logits_head(cfg, params, h[:, -1:, :])
    return logits[:, 0], cache


@torch.inference_mode()
def lm_decode_step(params: Params, cfg: LMConfig, token: torch.Tensor,
                   cur_len: int, cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One decode step: token (B,) at absolute position ``cur_len``.

    Writes this step's K/V into the caches in place. Returns (logits
    (B, vocab_padded), cache)."""
    _check_attn_impl(cfg)
    cur_len = int(cur_len)
    dev = token.device
    h = params["embed"][token][:, None, :].to(cfg.dtype)
    q_pos = torch.tensor([cur_len], dtype=torch.int32, device=dev)
    for ri, (kind, _) in enumerate(layer_runs(cfg)):
        rc = cache[ri]
        s_run = rc["k"].shape[2]
        window = _window(cfg, kind)
        ring = kind == "local" and window and s_run == window
        slot = cur_len % s_run if ring else cur_len
        if slot >= s_run:
            raise ValueError(f"position {cur_len} is past the cache's "
                             f"{s_run} slots")
        rc["pos"][slot] = cur_len
        slots = torch.tensor([slot], device=dev)
        for i, lp in enumerate(_layers(params["runs"][ri])):
            h = _layer_cached(cfg, window, h, lp, q_pos, rc["k"][i],
                              rc["v"][i], rc["pos"], slots)
    h = rms_norm(h, params["final_norm"])
    logits = _logits_head(cfg, params, h)
    return logits[:, 0], cache


@torch.inference_mode()
def lm_embed(params: Params, cfg: LMConfig,
             tokens: torch.Tensor) -> torch.Tensor:
    """Mean-pooled final hidden states (B, d_model): the hook that turns
    the LM into an embedder for the vector index."""
    _check_attn_impl(cfg)
    return _final_hidden(cfg, params, tokens)[0].mean(dim=1)
