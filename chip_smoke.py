#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits nonzero; no phase's failure is caught):
  1. device   CUDA must be present; prints the card's name and power limit.
  2. build    builds every CUDA kernel of the port (K1, K2, K4, K5, K6)
              from the checkout's sources, one nvcc per source, all at
              once (sm_90a), and times the build.
  3. edges    each kernel against its plain PyTorch version on edge
              cases. K1: ragged C, masked slots, k > #finite, exact int8
              ties, a deep merge. K2: ragged N, k > N, Q = 1, M not a
              multiple of 16, a large k, exact int8 ties, N = 1,000,000.
              K4: N = 1, 2, ragged N, N = 2048, a multi-tile N, repeated
              values, tau = 0 and tau = +inf. K5 (f32 and bf16): S = 1,
              16, 80 (ragged), 4096; G = 1 and 8; dh = 8 to 256; window
              16 at S = 1000, a window wider than S, window 1; and at bf16
              TinyLlama's heads at S = 32768 and Gemma3-4B's local layers
              (H 8 / KV 4 / dh 256, window 1024) at S = 8192. K6 (f32
              and bf16): T = 1, 63, 4096 with D x V of 64 x 256 (with and
              without a masked tail), 64 x 1000, 2048 x 1000 (masked) and
              2048 x 32000; int32 labels; a tied head (D contiguous); and
              Gemma3-4B's tied head embed.T (2560, 262144) at T = 512.
  4. path 1   the ivfpq path at full size: build_engine over a
              1,000,000 x 384 clustered f32 corpus made with numpy from a
              seed, spec qpad64>ivf1024x16>pq16x256:i8@kernel>rr64, then
              searches of 1, 8, 64 and 256 queries (k=10). Launch counts
              are zeroed just before and read just after; recall@10 is
              held against exact search on the card, and the same engine
              with @jnp must return the same ids.
  5. K1 main  K1 against its plain version on path 1's own scan inputs
              (batch 256) at f32, bf16 and int8.
  6. timings  K1, its plain version and the bound at batch 256; per-stage
              search times.
  7. trace    the card's busy share while searching (torch.profiler).
  8. path 2   the pq and opq kinds on the same corpus: build_engine with
              spec qpad64>pq16x256:i8@kernel>rr64 and the QPAD fit on
              MPADConfig(backend="kernel") (K4; counts zeroed just before
              the build and read just after: 64 x 48 = 3,072 launches),
              then an opq index over the same reduced corpus and reducer
              (get_ops("opq").build, SearchEngine.from_state). Both
              engines search 1, 8, 64 and 256 queries (K2 counted the
              same way); recall@10 against exact search, and @jnp must
              return the @kernel ids.
  9. K2, K4 main  K2 against its plain version on path 2's own tables and
              codes (batch 256, f32, bf16, int8); the kernel backend's phi
              value and gradient against the fast backend's on the fit
              sample.
  10. timings K2 and K4 beside their plain versions and bounds; p50
              latency and QPS of the pq and opq engines; the pq build's
              stage times.
  11. path 3  the LM serving path: TinyLlama-1.1B's CONFIG at full width
              and depth (22 layers), bf16, random weights from
              lm_init_params(cfg, seed=0) on the card, attn_impl="flash".
              Prefill 4 x 4096 tokens into a 4160-slot cache, then 64
              greedy lm_decode_steps; K5's count is zeroed just before and
              read just after (22 launches in the prefill, none in the
              decode, whose attention is chunked). The same prefill on
              attn_impl="chunked", decoding the flash route's tokens: the
              last-position logits and the greedy tokens must agree within
              LM_LOGIT_ATOL and LM_AGREE_FLOOR. lm_embed on the batch must
              be finite, (4, 2048).
  12. K5 main K5 against its plain version on path 3's own layer-0 q, k,
              v, at bf16 and upcast to f32.
  13. timings K5, its plain version, scaled_dot_product_attention (the
              library yardstick; the port never calls it) and the bound at
              path 3's shape; prefill ms, tokens/s and share of the bf16
              peak; decode ms a step (p50) and tokens/s; peak memory.
  14. trace   the card's busy share over one prefill and over 10 decode
              steps (torch.profiler).
  15. K5 Function  flash_attention's gradients against the all-plain route
              (chunked forward and backward) at TinyLlama's heads, B 2,
              S 1024, bf16.
  16. path 4  the LM training path: TinyLlama-1.1B's CONFIG at full width
              and depth, bf16, random weights from lm_init_params(cfg,
              seed=0), attn_impl="flash", on lm_token_batches(0, 4, 4096,
              32000). Step 0's loss and gradient against the reference
              route (attn_impl="chunked", the plain materialized-logits
              CE): |dloss| within TRAIN_LOSS_ATOL, the relative L2 of the
              gradients of lm_head, runs[0]['wq'] and embed within
              TRAIN_GRAD_REL. Then 4 steps of make_train_step(lm_train_
              forward, AdamW(lr 1e-3, warmup 5)), counts zeroed just
              before: each step must launch K5 44 times (forward and remat
              recompute of 22 layers) and K6 4 times (S / seq_chunk); loss
              and parameters finite. Step time (p50 of steps 1-3),
              tokens/s, share of the bf16 peak, peak memory.
  17. trace   one more training step under torch.profiler.
  18. K6 main K6 against its plain version on path 4's own first sequence
              chunk (T 4096, D 2048, V 32000) at bf16 and upcast to f32;
              its time beside its plain version's, its bound and the
              cross_entropy((h @ w).float()) yardstick (two calls; the
              port never calls it).
  19. drill   run_with_restarts at TinyLlama's SMOKE size on the card: 8
              steps, a checkpoint every 2, a failure injected at step 5;
              the final parameters must match an uninterrupted run within
              DRILL_ATOL.

Before those, one line {"result": {...}} holds every measurement of the
run (``result.path4`` for the training path). The line before the last is
{"kernels": [...]} (K1, K2, K4, K5, K6); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = "qpad64>ivf1024x16>pq16x256:i8@kernel>rr64"
SPEC_PQ = "qpad64>pq16x256:i8@kernel>rr64"
SPEC_OPQ = "qpad64>opq16x256:i8@kernel>rr64"
FIT = dict(m=64, b=80.0, alpha=25.0, iters=48, seed=0)   # path 2's QPAD fit
FIT_SAMPLE = 2048                # rows the engine fits on (its default)
N, DIM, SEED = 1_000_000, 384, 0
BATCHES = (1, 8, 64, 256)
K = 10
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM non-tensor f32 peak (data sheet)
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor peak (data sheet)
LUTS = ("f32", "bf16", "int8")
RECALL_FLOOR = 0.5               # a broken scan or re-rank lands far below
RERANK = 64                      # candidates the pq / opq scans return
# path 3: TinyLlama-1.1B serving, prefill B x S (train_4k's sequence;
# prefill_32k's batch 32 and sequence 32768 are cut to fit the time limit),
# then greedy decode steps into a cache of LM_MAX_LEN slots
LM_BATCH, LM_SEQ, LM_MAX_LEN, LM_DECODE = 4, 4096, 4160, 64
# flash and chunked prefill differ only in f32 summation order inside the
# attention, rounded to bf16 once, and carried through 22 layers: their
# last-position logits (std ~1 at random weights) may differ by a few bf16
# ulps of the hidden state, and greedy tokens may flip only on near-ties
LM_LOGIT_ATOL = 0.25
LM_AGREE_FLOOR = 0.75
# K6 against its plain version: the same f32 products (a bf16 product is
# exact in f32) summed in another order; losses are ~ln V ~ 10
K6_TOL = dict(atol=1e-4, rtol=1e-5)
# K5's Function against the all-plain route: the same chunked backward on
# the same cotangent, so the gradients agree to f32 rounding
K5_GRAD_RTOL = 1e-5
# path 4: TinyLlama-1.1B training at train_4k's sequence 4096, its batch
# 256 cut to 4 (one card's memory and the run's time), 4 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 4
# flash + K6 against chunked + the plain CE on step 0: both routes in bf16,
# differing in the f32 summation order inside attention (rounded to bf16
# once a layer, through 22 layers and back) and inside the CE; at SMOKE
# size the port and JAX, which round bf16 at more places, differ by 1.4e-3
# in the loss and 1.5-3% in gradient L2
TRAIN_LOSS_ATOL = 0.01
TRAIN_GRAD_REL = 0.05
# the restart drill at TinyLlama's SMOKE size (f32): not bit for bit on the
# card, since the embedding gather's backward accumulates with atomics, in
# an order that changes from run to run; a ulp of a gradient moves an
# AdamW update by far less than lr = 1e-3
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 8, 2, 5
DRILL_ATOL = 1e-4


# kernel-name fragments for a trace's device time by group (first match)
KERNEL_GROUPS = (
    ("K5 flash_fwd", ("flash_fwd",)),
    ("K6 ce_partial/ce_merge", ("ce_partial", "ce_merge")),
    ("K1/K2/K4", ("adc_", "pair_")),
    ("GEMM f32", ("f32f32_f32f32",)),
    ("GEMM bf16", ("gemm", "xmma", "cutlass", "nvjet")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce_kernel",)),
    ("index/scatter/gather", ("index", "scatter", "gather")),
    ("copy", ("copy", "cat")),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def clustered_corpus(n, d, seed, n_clusters=4096, spread=32, local=16):
    """Unit-norm clustered embeddings of low intrinsic dimension, as
    sentence-embedding corpora have: cluster centres in a ``spread``-dim
    subspace, each point offset from its centre in a ``local``-dim
    subspace, plus small isotropic noise. numpy, from ``seed``; the
    subspaces come from ``seed`` alone, so corpus and queries
    (another ``seed`` offset of the same generator family) share them."""
    base_rng = np.random.default_rng(12345)
    b1 = base_rng.standard_normal((spread, d), dtype=np.float32) / np.sqrt(d)
    b2 = base_rng.standard_normal((local, d), dtype=np.float32) / np.sqrt(d)
    centers = base_rng.standard_normal((n_clusters, spread),
                                       dtype=np.float32) @ b1
    rng = np.random.default_rng(seed)
    out = np.empty((n, d), np.float32)
    for s in range(0, n, 200_000):
        e = min(n, s + 200_000)
        lab = rng.integers(0, n_clusters, e - s)
        z = rng.standard_normal((e - s, local), dtype=np.float32)
        x = (centers[lab] + 0.4 * (z @ b2)
             + 0.01 * rng.standard_normal((e - s, d), dtype=np.float32))
        out[s:e] = x / np.linalg.norm(x, axis=1, keepdims=True)
    return out


def cuda_ms(torch, fn, reps, warmup=2):
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps, match):
    """Device time per call, in ms, of the kernels whose names contain
    ``match``, from a torch.profiler trace of ``reps`` calls. For a kernel
    shorter than its launch, CUDA events around back-to-back calls time
    the host's launches instead (``cuda_ms`` is kept beside it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and match in e.key)
    check(us > 0, f"the profiler saw no device time of {match!r}")
    return us / reps / 1e3


def compare_k1(torch, ops, ref, name, tables, codes, base, k, lut, scale):
    """K1 against its plain version on the same CUDA tensors. int8: d2 and
    ids equal. f32/bf16: d2 within 1e-6 relative to the magnitude of the
    summands (|base| + sum_m max|T|, per query: the table terms and the
    base cancel, so the result itself can be far smaller), and every id
    the kernel returns scores, under the plain scorer, within that of the
    kernel's d2 (ids differ only on such near-ties). Returns max |err|."""
    dk, ik = ops.pq_adc_gather_topk(tables, codes, base, k, lut, scale)
    torch.cuda.synchronize()
    dp, ip = ops.pq_adc_gather_topk_plain(tables, codes, base, k, lut, scale)
    fin = torch.isfinite(dp)
    check(torch.equal(torch.isfinite(dk), fin), f"{name}: finite mask")
    check(torch.equal(ik[~fin], ip[~fin]), f"{name}: unfilled slots")
    err = float((dk[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    if lut == "int8":
        check(torch.equal(dk, dp), f"{name}: int8 d2 not bit-equal")
        check(torch.equal(ik, ip), f"{name}: int8 ids differ")
    else:
        fb = torch.where(torch.isfinite(base), base.abs(), 0.0)
        mag = fb.amax(dim=1) + tables.abs().amax(dim=2).sum(dim=1)  # (Q,)
        tol = (1e-6 * mag[:, None]).expand_as(dp)[fin]
        check(bool(((dk[fin] - dp[fin]).abs() <= tol).all()),
              f"{name}: d2 beyond 1e-6 of the summands (max err {err})")
        scores = ref.pq_adc_gather_scores_ref(tables, codes, base, lut, scale)
        got = torch.gather(scores, 1, ik.clamp_min(0))[fin]
        check(bool(((got - dk[fin]).abs() <= tol).all()),
              f"{name}: an id does not score its distance")
        same = float((ik == ip).float().mean())
        log(f"  {name}: ids equal on {same:.6f} of slots")
    log(f"  {name}: ok, max |d2 err| {err:.3e}")
    return err


def busy_share(torch, fn, reps, label, top=6):
    """Share of a window of ``reps`` calls of ``fn`` in which the card runs
    a kernel: the kernels' device time (one stream, so no overlap) from a
    torch.profiler trace over the host time of the window, which ends in
    a synchronize. The profiler slows the host, so the idle share it
    implies is an upper bound. Logs and returns the share, the kernels
    launched per call and the top kernels with their device µs per
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    check(busy_us > 0, "the profiler saw no device time")
    groups = {}
    for e in kern:
        g = next((g for g, keys in KERNEL_GROUPS if any(k in e.key
                                                        for k in keys)),
                 "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / reps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:top]
    out = {"busy_share": busy_us / wall_us,
           "device_us_per_call": busy_us / reps,
           "kernels_per_call": sum(e.count for e in kern) / reps,
           "top_kernels_us": [(e.key[:60], e.self_device_time_total / reps,
                               e.count / reps) for e in top],
           "device_us_by_group": groups}
    log(f"[trace] {label}: device busy {out['busy_share']:.3f} of the "
        f"window, {out['kernels_per_call']:.0f} kernels a call; top kernels "
        f"(us per call): "
        f"{[(n, round(t, 1), c) for n, t, c in out['top_kernels_us']]}")
    return out


def device_busy(torch, eng, queries, label, reps=10):
    """``busy_share`` of ``reps`` searches, after one warm-up search."""
    eng.search(queries, K)
    return busy_share(torch, lambda: eng.search(queries, K), reps, label)


def lm_serve(torch, tf, fa, params, cfg, tokens, steps, teacher=None):
    """One prefill of ``tokens`` (B, S) into a fresh cache of LM_MAX_LEN
    slots, then ``steps`` greedy decode steps, each fed the last step's
    argmax over [:vocab] (as lm_family's smoke does), or ``teacher``'s
    token at that step when given. Returns (prefill logits, greedy tokens
    (B, steps + 1), K5 launches in the prefill, K5 launches in the decode,
    the prefill's host ms, each decode step's ms by CUDA events)."""
    cache = tf.init_cache(cfg, tokens.shape[0], LM_MAX_LEN)
    torch.cuda.synchronize()
    n0 = fa.flash_attention_fwd.launches
    t0 = time.perf_counter()
    logits, cache = tf.lm_prefill(params, cfg, tokens, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    n1 = fa.flash_attention_fwd.launches
    first = logits
    toks = [logits[:, :cfg.vocab].argmax(dim=-1)]
    step_ms = []
    for i in range(steps):
        feed = toks[-1] if teacher is None else teacher[:, i]
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        logits, cache = tf.lm_decode_step(params, cfg, feed, tokens.shape[1]
                                          + i, cache)
        e.record()
        toks.append(logits[:, :cfg.vocab].argmax(dim=-1))
        torch.cuda.synchronize()
        step_ms.append(s.elapsed_time(e))
        check(bool(torch.isfinite(logits).all()), f"decode step {i}: "
              "non-finite logits")
    return (first, torch.stack(toks, dim=1), n1 - n0,
            fa.flash_attention_fwd.launches - n1, prefill_ms, step_ms)


def lm_path(torch, tf, fa, lm_param_count, rms_norm, base_cfg, counters):
    """Path 3: ``base_cfg`` (TinyLlama-1.1B) at full width, bf16, random
    weights from seed 0, served with attn_impl="flash" (K5 in every
    prefill layer), held against the chunked route. Returns (result
    dict, K5 launches on the main run, K5's max |err| on the path's own
    q, k, v, K5 timing dict)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    cfg = dataclasses.replace(base_cfg, attn_impl="flash")
    out = {"config": cfg.name, "batch": LM_BATCH, "seq": LM_SEQ,
           "max_len": LM_MAX_LEN, "decode_steps": LM_DECODE}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["mem_before_gb"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = tf.lm_init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, (LM_BATCH, LM_SEQ))).to(dev)

    # the main run: counts zeroed just before, read just after
    for fn in counters:
        fn.launches = 0
    logits, toks, n_pre, n_dec, pre_ms, step_ms = lm_serve(
        torch, tf, fa, params, cfg, tokens, LM_DECODE)
    launches = fa.flash_attention_fwd.launches
    others = {fn.__name__: fn.launches for fn in counters
              if fn is not fa.flash_attention_fwd}
    log(f"[path 3] {cfg.name} prefill {LM_BATCH} x {LM_SEQ} + {LM_DECODE} "
        f"decode steps: K5 launches {n_pre} in the prefill, {n_dec} in the "
        f"decode; other kernels {others}")
    check(n_pre == cfg.n_layers and n_dec == 0 and launches == n_pre,
          f"K5 launched {n_pre} times in the prefill (want {cfg.n_layers}) "
          f"and {n_dec} in the decode (want 0)")
    check(not any(others.values()), "a search kernel ran on path 3")
    check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), "bad prefill logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "bad tokens")
    out["k5_launches_prefill"] = n_pre
    out["k5_launches_decode"] = n_dec
    out["first_prefill_ms"] = pre_ms
    out["decode_step_ms"] = {"p50": float(np.median(step_ms)),
                             "p90": float(np.percentile(step_ms, 90)),
                             "first": step_ms[0]}
    out["decode_tok_per_s"] = LM_BATCH / (out["decode_step_ms"]["p50"] / 1e3)

    # the same prefill on the chunked route, decoding the flash route's
    # tokens (teacher-forced), so each step compares one context
    cfg_c = dataclasses.replace(cfg, attn_impl="chunked")
    logits_c, toks_c, n_pre_c, _, _, _ = lm_serve(
        torch, tf, fa, params, cfg_c, tokens, LM_DECODE, teacher=toks)
    check(n_pre_c == 0, "K5 ran on the chunked route")
    ldiff = float((logits.float() - logits_c.float()).abs().max())
    agree = float((toks_c == toks).float().mean())
    out["flash_vs_chunked"] = {
        "logits_max_abs_diff": ldiff, "logits_abs_max":
        float(logits.float().abs().max()), "greedy_agreement": agree,
        "tolerance": {"logits_atol": LM_LOGIT_ATOL,
                      "agreement_floor": LM_AGREE_FLOOR}}
    log(f"[path 3] flash vs chunked: last-position logits max |diff| "
        f"{ldiff:.4f} (|logits| up to {out['flash_vs_chunked']['logits_abs_max']:.3f}),"
        f" greedy tokens agree on {agree:.4f} of {toks.numel()}")
    check(ldiff <= LM_LOGIT_ATOL, f"flash and chunked logits differ by "
          f"{ldiff} > {LM_LOGIT_ATOL}")
    check(agree >= LM_AGREE_FLOOR, f"greedy agreement {agree} < "
          f"{LM_AGREE_FLOOR}")

    # the embedding hook on one batch (K5 again in every layer)
    n0 = fa.flash_attention_fwd.launches
    emb = tf.lm_embed(params, cfg, tokens)
    torch.cuda.synchronize()
    check(tuple(emb.shape) == (LM_BATCH, cfg.d_model)
          and bool(torch.isfinite(emb).all())
          and fa.flash_attention_fwd.launches - n0 == cfg.n_layers,
          f"lm_embed: {tuple(emb.shape)}, finite "
          f"{bool(torch.isfinite(emb).all())}, "
          f"{fa.flash_attention_fwd.launches - n0} K5 launches")
    log(f"[path 3] lm_embed {tuple(emb.shape)} finite, "
        f"{cfg.n_layers} K5 launches")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # K5 on the path's own layer-0 q, k, v, at bf16 and upcast to f32
    log("[K5 main]")
    lp0 = {key: t[0] for key, t in params["runs"][0].items()}
    with torch.inference_mode():
        x = rms_norm(params["embed"][tokens].to(cfg.dtype), lp0["ln1"])
        q, k, v = tf._qkv(cfg, x, lp0, torch.arange(LM_SEQ, device=dev),
                          None)
    err = compare_k5(torch, fa, "K5 main bf16", q, k, v, None)
    err = max(err, compare_k5(torch, fa, "K5 main f32", q.float(),
                              k.float(), v.float(), None))

    # timings, second call on
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    k5_ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), reps=10)
    k5_plain = cuda_ms(torch, lambda: fa.flash_attention_fwd_plain(q, k, v),
                       reps=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                          enable_gqa=True)
    sdpa_err = float((sdpa.transpose(1, 2).float()
                      - fa.flash_attention_fwd(q, k, v).float()).abs().max())
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
    bound, by, nops, nbytes = k5_bound(LM_BATCH, LM_SEQ, h, kvh, dh, None, 2)
    log(f"[timings] K5 {k5_ms:.4f} ms, plain {k5_plain:.4f} ms, SDPA "
        f"{lib_ms:.4f} ms (max |diff| to K5 {sdpa_err:.3e}), bound "
        f"{bound:.4f} ms ({by}: {nops:.4g} ops, {nbytes} B) at B={LM_BATCH} "
        f"S={LM_SEQ} H={h} KV={kvh} dh={dh} bf16")
    k5 = {"ms": k5_ms, "plain_ms": k5_plain, "library_ms": lib_ms,
          "bound_ms": bound, "bound_by": by, "ops": nops, "bytes": nbytes,
          "sdpa_max_abs_diff": sdpa_err}
    del qt, kt, vt, sdpa

    def prefill_once(c):
        cache = tf.init_cache(c, LM_BATCH, LM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.lm_prefill(params, c, tokens, cache)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    pre = [prefill_once(cfg) for _ in range(3)]
    pre_c = [prefill_once(cfg_c) for _ in range(2)]
    model_flops = (2 * lm_param_count(cfg) * LM_BATCH * LM_SEQ
                   + cfg.n_layers * nops)
    p50 = float(np.median(pre))
    out["prefill_ms"] = {"flash": pre, "chunked": pre_c}
    out["prefill_tok_per_s"] = LM_BATCH * LM_SEQ / (p50 / 1e3)
    out["prefill_model_flops"] = model_flops
    out["prefill_peak_share"] = model_flops / (p50 / 1e3) / BF16_OPS_PER_S
    log(f"[timings] prefill {LM_BATCH} x {LM_SEQ}: flash "
        f"{[round(t, 2) for t in pre]} ms, chunked "
        f"{[round(t, 2) for t in pre_c]} ms; {out['prefill_tok_per_s']:.0f} "
        f"tok/s; {model_flops:.4g} FLOPs = {out['prefill_peak_share']:.4f} "
        f"of the bf16 peak")
    log(f"[timings] decode p50 {out['decode_step_ms']['p50']:.3f} ms a step "
        f"(p90 {out['decode_step_ms']['p90']:.3f}, first "
        f"{out['decode_step_ms']['first']:.3f}), "
        f"{out['decode_tok_per_s']:.1f} tok/s at batch {LM_BATCH}; peak "
        f"memory {out['peak_mem_gb']:.2f} GB (before path 3: "
        f"{out['mem_before_gb']:.2f} GB)")

    # the card's busy share: one prefill, then 10 decode steps
    cache = tf.init_cache(cfg, LM_BATCH, LM_MAX_LEN)
    step = iter(range(LM_SEQ, LM_SEQ + 10))
    nxt = toks[:, 0]
    out["busy"] = {
        "prefill": busy_share(
            torch, lambda: tf.lm_prefill(params, cfg, tokens, cache), 1,
            "path 3 prefill"),
        "decode": busy_share(
            torch, lambda: tf.lm_decode_step(params, cfg, nxt, next(step),
                                             cache), 10, "path 3 decode")}
    return out, launches, err, k5


def k6_inputs(torch, seed, t, d, v, vocab, dtype, tied=False):
    """h (T, D) ~ N(0, 1) and a head w (D, V) ~ N(0, 1/D), so logits are
    ~N(0, 1) as at initialisation; labels (T,) int64 below ``vocab``. A
    tied head is the transposed view of a (V, D) embedding, D contiguous."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d), dtype=np.float32)
    w = (rng.standard_normal((v, d) if tied else (d, v), dtype=np.float32)
         / np.sqrt(d))
    labels = rng.integers(0, vocab, t)
    h, w, labels = (torch.from_numpy(a).to("cuda") for a in (h, w, labels))
    w = w.to(dtype)
    return h.to(dtype), (w.T if tied else w), labels


def compare_k6(torch, fce, name, h, w, labels, vocab):
    """K6 against its plain version on the same CUDA tensors: per-token
    loss within K6_TOL (the same f32 products, summed in another order; a
    bf16 product is exact in f32, so bf16 inputs take the same tolerance),
    and bit-equal on a second call (no atomics). Returns max |err|."""
    got = fce.fused_ce_fwd(h, w, labels, vocab)
    torch.cuda.synchronize()
    want = fce.fused_ce_fwd_plain(h, w, labels, vocab)
    check(got.dtype == torch.float32 and got.shape == labels.shape,
          f"{name}: output {got.dtype} {tuple(got.shape)}")
    diff = (got - want).abs()
    err = float(diff.max())
    ok = bool((diff <= K6_TOL["atol"] + K6_TOL["rtol"] * want.abs()).all())
    check(ok and bool(torch.isfinite(got).all()),
          f"{name}: beyond {K6_TOL} (max err {err})")
    check(torch.equal(fce.fused_ce_fwd(h, w, labels, vocab), got),
          f"{name}: a second call differs")
    log(f"  {name}: ok, max |err| {err:.3e} (loss up to "
        f"{float(want.abs().max()):.2f})")
    return err


def edge_cases_k6(torch, fce):
    """K6 on T = 1, 63 (ragged) and 4096; (D, V, vocab) of 64 x 256 with
    and without a masked tail, a ragged V (1000), D 2048 with V 1000 and a
    masked tail, and TinyLlama's 2048 x 32000; f32 and bf16; int32 labels
    once; a tied head (D contiguous); and Gemma3-4B's tied head, embed.T
    (2560, 262144) bf16, at T = 512."""
    err = 0.0
    i = 0
    for t in (1, 63, 4096):
        for d, v, vocab in ((64, 256, 256), (64, 256, 200), (64, 1000, 1000),
                            (2048, 1000, 937), (2048, 32000, 32000)):
            for name, dt in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
                i += 1
                h, w, labels = k6_inputs(torch, 20 + i, t, d, v, vocab, dt)
                err = max(err, compare_k6(
                    torch, fce, f"K6 edge {name} T={t} D={d} V={v} "
                    f"vocab={vocab}", h, w, labels, vocab))
    h, w, labels = k6_inputs(torch, 5, 63, 64, 1000, 900, torch.float32)
    err = max(err, compare_k6(torch, fce, "K6 edge int32 labels", h, w,
                              labels.int(), 900))
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        h, w, labels = k6_inputs(torch, 6, 300, 2048, 32000, 31000, dt,
                                 tied=True)
        err = max(err, compare_k6(torch, fce, f"K6 edge tied {name} T=300 "
                                  "D=2048 V=32000 vocab=31000", h, w, labels,
                                  31000))
    h, w, labels = k6_inputs(torch, 7, 512, 2560, 262144, 262144,
                             torch.bfloat16, tied=True)
    err = max(err, compare_k6(torch, fce, "K6 edge gemma3-4b tied head "
                              "embed.T (2560, 262144) bf16 T=512", h, w,
                              labels, None))
    return err


def k6_bound(t, d, v, h_bytes, w_bytes):
    """The least time of one K6 call: the larger of its operations (a
    multiply-add per (row, column, depth)) at the bf16 tensor peak and its
    bytes (h, w and the int64 labels read once, the f32 loss written
    once) at the HBM rate. Returns (ms, by, ops, bytes)."""
    nops = 2 * t * d * v
    nbytes = t * d * h_bytes + d * v * w_bytes + t * 8 + t * 4
    t_ops, t_bytes = nops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nops, nbytes)


def train_flops(cfg, lm_param_count, k5_nops):
    """Model FLOPs of one training step of TRAIN_BATCH x TRAIN_SEQ tokens:
    6 * params * tokens (every parameter, the embedding and the head
    included: forward 2, backward 4), plus each layer's causal attention
    (``k5_nops``, the multiply-adds of q.k and p.v over the pairs the mask
    keeps) four times: the forward, the backward (twice the forward) and
    the remat recompute."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return 6 * lm_param_count(cfg) * tokens + 4 * cfg.n_layers * k5_nops


def k5_function_check(torch, fa, cfg):
    """K5's autograd.Function against the all-plain route (the chunked
    forward and its autograd backward) at ``cfg``'s heads, B 2, S 1024,
    bf16. The loss is linear in the output (sum(out * r)), so the
    cotangent does not depend on which forward ran, and both backwards
    are the same chunked recompute: the gradients agree to
    K5_GRAD_RTOL of their largest entry. Returns the max relative err."""
    rng = np.random.default_rng(8)
    shapes = ((2, 1024, cfg.n_heads, cfg.d_head),
              (2, 1024, cfg.n_kv_heads, cfg.d_head),
              (2, 1024, cfg.n_kv_heads, cfg.d_head))
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to("cuda").to(torch.bfloat16) for s in shapes)
    r = torch.from_numpy(rng.standard_normal(shapes[0], dtype=np.float32)
                         ).to("cuda")
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_fwd_plain):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        grads.append(torch.autograd.grad((out.float() * r).sum(), leaves))
    torch.cuda.synchronize()
    err = 0.0
    for name, got, want in zip("qkv", *grads):
        scale = float(want.float().abs().max())
        e = float((got.float() - want.float()).abs().max()) / scale
        check(got.dtype == torch.bfloat16 and e <= K5_GRAD_RTOL,
              f"K5 Function d{name}: max |err| {e} of max |grad| {scale}")
        err = max(err, e)
    log(f"[K5 Function] B=2 S=1024 H={cfg.n_heads} KV={cfg.n_kv_heads} "
        f"dh={cfg.d_head} bf16: dq, dk, dv within {err:.3e} of the "
        "all-plain route (relative to max |grad|)")
    return err


def rel_l2(torch, a, b):
    return float(torch.linalg.vector_norm((a.float() - b.float()))
                 / torch.linalg.vector_norm(b.float()))


def reference_loss(torch, tf, fce, cfg, params, batch):
    """The reference route of lm_loss: ``cfg``'s attention (chunked) and
    the plain materialized-logits CE (``ce_ref``) over the same sequence
    chunks."""
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    h = tf._final_hidden(cfg, params, tokens)
    ck = min(cfg.seq_chunk, s)
    total = 0.0
    for c0 in range(0, s, ck):
        total = total + fce.ce_ref(h[:, c0:c0 + ck].reshape(-1, cfg.d_model),
                                   params["lm_head"],
                                   labels[:, c0:c0 + ck].reshape(-1),
                                   cfg.vocab).sum()
    return total / (b * s)


def restart_drill(torch, tf, optim, data, runtime, smoke_cfg):
    """run_with_restarts at ``smoke_cfg`` (TinyLlama's SMOKE, flash) on the
    card: DRILL_STEPS steps, a checkpoint every DRILL_EVERY, once with a
    failure injected at DRILL_FAIL and once without. Returns (max |param
    diff|, bit-equal?, restarts seen)."""
    import tempfile
    cfg = dataclasses.replace(smoke_cfg, attn_impl="flash")
    batches = list(data.lm_token_batches(SEED, 4, 64, cfg.vocab,
                                         n_steps=DRILL_STEPS))
    step = optim.make_train_step(
        lambda p, b: tf.lm_train_forward(p, cfg, b),
        optim.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=DRILL_STEPS))
    calls = []

    def step_fn(state, i):
        calls.append(i)
        _, p, o = step(state["params"], state["opt"], batches[i])
        return {"params": p, "opt": o}

    finals = []
    build_dir = os.path.join(HERE, "build")
    os.makedirs(build_dir, exist_ok=True)
    for fail_at in ((), (DRILL_FAIL,)):
        params = tf.lm_init_params(cfg, seed=SEED)
        with tempfile.TemporaryDirectory(dir=build_dir) as ckpt:
            finals.append(runtime.run_with_restarts(
                step_fn, {"params": params,
                          "opt": optim.init_opt_state(params)},
                DRILL_STEPS, ckpt, ckpt_every=DRILL_EVERY,
                injector=runtime.FailureInjector(fail_at)))
    # the faulty run replays from the checkpoint after step DRILL_FAIL - 1
    # rounded down to the checkpoint period
    replayed = len(calls) - 2 * DRILL_STEPS
    leaves = [(k, a.detach(), b.detach()) for (k, a), (_, b) in zip(
        _keyed(finals[0]), _keyed(finals[1]))]
    diff = max(float((a.float() - b.float()).abs().max())
               for _, a, b in leaves)
    same = all(torch.equal(a, b) for _, a, b in leaves)
    check(int(finals[1]["opt"]["step"]) == DRILL_STEPS,
          "the drill did not reach its last step")
    check(diff <= DRILL_ATOL, f"restart drill: params differ by {diff} > "
          f"{DRILL_ATOL}")
    log(f"[path 4] restart drill ({cfg.name}, {DRILL_STEPS} steps, "
        f"checkpoint every {DRILL_EVERY}, failure at step {DRILL_FAIL}): "
        f"{replayed} steps replayed; final params within {diff:.3e} of the "
        f"uninterrupted run (bit-equal: {same})")
    return diff, same, replayed


def train_parts(torch, fa, fce, optim, cfg, params, opt):
    """Device time (CUDA events) of the parts of a step at path 4's
    shapes: one layer's attention backward (the Function's chunked
    recompute and autograd), one K6 forward and one CE backward (T =
    B * seq_chunk), and one AdamW update of every parameter (on the
    trained state, which it moves once more)."""
    rng = np.random.default_rng(9)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, n, cfg.d_head), dtype=np.float32)).to("cuda")
        .to(torch.bfloat16).requires_grad_()
        for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    ct = torch.ones_like(q)
    out = fa.flash_attention(q, k, v)
    attn_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (q, k, v), ct, retain_graph=True), reps=2, warmup=1)
    del out
    t = b * cfg.seq_chunk
    h = torch.from_numpy(rng.standard_normal((t, cfg.d_model),
                                             dtype=np.float32)).to("cuda")
    h = h.to(torch.bfloat16).requires_grad_()
    head = params["lm_head"]
    lab = torch.from_numpy(rng.integers(0, cfg.vocab, t)).to("cuda")
    loss = fce.fused_ce(h, head, lab, cfg.vocab).sum()
    ce_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        loss, (h, head), retain_graph=True), reps=2, warmup=1)
    # the parameters stand in for a gradient: bf16, of the right shapes
    adam = cuda_ms(torch, lambda: optim.adamw_update(
        params, opt, params, optim.AdamWConfig()), reps=2, warmup=1)
    parts = {"attention_backward_one_layer": attn_bwd,
             "ce_backward_one_call": ce_bwd, "adamw_update": adam}
    log(f"[timings] path 4 parts (ms): attention backward of one layer "
        f"{attn_bwd:.1f} (x {cfg.n_layers} a step), CE backward of one "
        f"chunk {ce_bwd:.1f} (x {TRAIN_SEQ // cfg.seq_chunk}), AdamW "
        f"update {adam:.1f}")
    return parts


def _keyed(tree):
    from repro_torch._tree import keyed_leaves
    return keyed_leaves(tree)


def train_path(torch, mods, base_cfg, smoke_cfg, counters):
    """Path 4: ``base_cfg`` (TinyLlama-1.1B) at full width and depth, bf16,
    random weights from seed 0, trained with attn_impl="flash" (K5 forward
    and its remat recompute in every layer, K6 for each sequence chunk's
    CE) and AdamW, held against the chunked route with the plain CE.
    Returns (result dict, K6 launches on the main run, K5 launches on the
    main run, K6's max |err| on the path's own inputs, K6 timing dict,
    the K5 Function's max relative err)."""
    import torch.nn.functional as F
    tf, fa, fce, optim, data, runtime, lm_param_count = mods
    cfg = dataclasses.replace(base_cfg, attn_impl="flash")
    cfg_c = dataclasses.replace(base_cfg, attn_impl="chunked")
    out = {"config": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "seq_chunk": cfg.seq_chunk,
           "remat": cfg.remat}
    k5_fn_err = k5_function_check(torch, fa, base_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["mem_before_gb"] = torch.cuda.memory_allocated() / 1e9
    params = tf.lm_init_params(cfg, seed=SEED)
    batches = list(data.lm_token_batches(SEED, TRAIN_BATCH, TRAIN_SEQ,
                                         cfg.vocab, n_steps=TRAIN_STEPS + 1))
    n_chunks = TRAIN_SEQ // cfg.seq_chunk
    want5, want6 = 2 * cfg.n_layers, n_chunks

    # step 0's loss and gradient on both routes, before any update
    def loss_fn(p, b):
        return tf.lm_train_forward(p, cfg, b)

    n5, n6 = fa.flash_attention_fwd.launches, fce.fused_ce_fwd.launches
    loss_f, grads = optim.value_and_grad(loss_fn, params, batches[0])
    torch.cuda.synchronize()
    check(fa.flash_attention_fwd.launches - n5 == want5
          and fce.fused_ce_fwd.launches - n6 == want6,
          "step 0's gradient: K5 / K6 launched "
          f"{fa.flash_attention_fwd.launches - n5} / "
          f"{fce.fused_ce_fwd.launches - n6} times")
    gnorm0 = float(optim.global_norm(grads))
    keep = {"lm_head": grads["lm_head"], "runs[0].wq": grads["runs"][0]["wq"],
            "embed": grads["embed"]}
    del grads
    n5, n6 = fa.flash_attention_fwd.launches, fce.fused_ce_fwd.launches
    loss_r, grads_r = optim.value_and_grad(
        lambda p, b: reference_loss(torch, tf, fce, cfg_c, p, b), params,
        batches[0])
    torch.cuda.synchronize()
    check(fa.flash_attention_fwd.launches == n5
          and fce.fused_ce_fwd.launches == n6, "a kernel ran on the "
          "reference route")
    ref = {"lm_head": grads_r["lm_head"],
           "runs[0].wq": grads_r["runs"][0]["wq"], "embed": grads_r["embed"]}
    gnorm_r = float(optim.global_norm(grads_r))
    del grads_r
    dloss = abs(float(loss_f) - float(loss_r))
    rels = {k: rel_l2(torch, keep[k], ref[k]) for k in keep}
    del keep, ref
    out["step0"] = {"loss": float(loss_f), "loss_reference": float(loss_r),
                    "abs_dloss": dloss, "grad_norm": gnorm0,
                    "grad_norm_reference": gnorm_r, "grad_rel_l2": rels,
                    "tolerance": {"loss_atol": TRAIN_LOSS_ATOL,
                                  "grad_rel_l2": TRAIN_GRAD_REL}}
    log(f"[path 4] step 0: loss {float(loss_f):.5f} (flash + K6) vs "
        f"{float(loss_r):.5f} (chunked + plain CE), |dloss| {dloss:.3e}; "
        f"grad norm {gnorm0:.4f} vs {gnorm_r:.4f}; grad rel L2 "
        f"{ {k: round(v, 6) for k, v in rels.items()} }")
    check(np.isfinite(float(loss_f)) and np.isfinite(gnorm0),
          "step 0: non-finite loss or grad norm")
    check(dloss <= TRAIN_LOSS_ATOL, f"|dloss| {dloss} > {TRAIN_LOSS_ATOL}")
    check(all(v <= TRAIN_GRAD_REL for v in rels.values()),
          f"grad rel L2 {rels} beyond {TRAIN_GRAD_REL}")

    # the main run: TRAIN_STEPS steps, counts zeroed just before
    step = optim.make_train_step(loss_fn, optim.AdamWConfig(
        lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS))
    opt = optim.init_opt_state(params)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    losses, step_ms, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        n5, n6 = fa.flash_attention_fwd.launches, fce.fused_ce_fwd.launches
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append((fa.flash_attention_fwd.launches - n5,
                         fce.fused_ce_fwd.launches - n6))
        log(f"[path 4] step {i}: loss {losses[-1]:.5f}, {step_ms[-1]:.1f} "
            f"ms, K5 {per_step[-1][0]} / K6 {per_step[-1][1]} launches")
    k5_launches = fa.flash_attention_fwd.launches
    k6_launches = fce.fused_ce_fwd.launches
    others = {fn.__name__: fn.launches for fn in counters
              if fn not in (fa.flash_attention_fwd, fce.fused_ce_fwd)}
    check(all(p == (want5, want6) for p in per_step),
          f"launches per step {per_step}, want ({want5}, {want6})")
    check(not any(others.values()), f"a search kernel ran on path 4: "
          f"{others}")
    check(all(np.isfinite(x) for x in losses), f"non-finite loss {losses}")
    with torch.no_grad():
        pnorm = float(optim.global_norm(params))
    check(np.isfinite(pnorm) and int(opt["step"]) == TRAIN_STEPS,
          "non-finite parameters after training")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    p50 = float(np.median(step_ms[1:]))
    _, _, k5_nops, _ = k5_bound(TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads,
                                cfg.n_kv_heads, cfg.d_head, None, 2)
    flops = train_flops(cfg, lm_param_count, k5_nops)
    out.update({
        "losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
        "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3),
        "model_flops": flops, "peak_share": flops / (p50 / 1e3)
        / BF16_OPS_PER_S, "launches_per_step": per_step,
        "param_norm_after": pnorm})
    log(f"[path 4] {cfg.name} train {TRAIN_BATCH} x {TRAIN_SEQ}: step p50 "
        f"{p50:.1f} ms (steps 1-{TRAIN_STEPS - 1}; step 0 "
        f"{step_ms[0]:.1f}), {out['tok_per_s']:.0f} tok/s, {flops:.4g} model "
        f"FLOPs = {out['peak_share']:.4f} of the bf16 peak; peak memory "
        f"{out['peak_mem_gb']:.2f} GB (before path 4: "
        f"{out['mem_before_gb']:.2f} GB); K5 {k5_launches}, K6 {k6_launches} "
        "launches")

    # one more step under the profiler: where the step's time goes
    out["busy"] = busy_share(
        torch, lambda: step(params, opt, batches[TRAIN_STEPS]), 1,
        "path 4 train step", top=12)
    by_group = out["busy"]["device_us_by_group"]
    log(f"[trace] path 4 device ms by group: "
        f"{ {k: round(v / 1e3, 1) for k, v in by_group.items()} }")

    # K6 on the path's own inputs: the first sequence chunk of batch 0
    log("[K6 main]")
    with torch.no_grad():
        h = tf._final_hidden(cfg, params, batches[0]["tokens"])
        hc = h[:, :cfg.seq_chunk].reshape(-1, cfg.d_model)
        del h
        head = params["lm_head"].detach()
        lab = batches[0]["labels"][:, :cfg.seq_chunk].reshape(-1)
        err = compare_k6(torch, fce, "K6 main bf16", hc, head, lab,
                         cfg.vocab)
        err = max(err, compare_k6(torch, fce, "K6 main f32", hc.float(),
                                  head.float(), lab, cfg.vocab))
        t = hc.shape[0]
        k6_ms = cuda_ms(torch, lambda: fce.fused_ce_fwd(hc, head, lab,
                                                        cfg.vocab), reps=10)
        plain_ms = cuda_ms(torch, lambda: fce.fused_ce_fwd_plain(
            hc, head, lab, cfg.vocab), reps=3, warmup=1)
        ce = F.cross_entropy((hc @ head).float(), lab, reduction="none")
        ce_diff = float((ce - fce.fused_ce_fwd(hc, head, lab,
                                               cfg.vocab)).abs().max())
        yard_ms = cuda_ms(torch, lambda: F.cross_entropy(
            (hc @ head).float(), lab, reduction="none"), reps=10)
    bound, by, nops, nbytes = k6_bound(t, cfg.d_model, head.shape[1], 2, 2)
    log(f"[timings] K6 {k6_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}: {nops:.4g} ops, {nbytes} B) at T={t} "
        f"D={cfg.d_model} V={head.shape[1]} bf16; no single PyTorch call "
        f"computes K6; yardstick cross_entropy((h @ w).float()) "
        f"{yard_ms:.4f} ms (two calls, bf16 logits; max |diff| to K6 "
        f"{ce_diff:.3e})")
    k6 = {"ms": k6_ms, "plain_ms": plain_ms, "bound_ms": bound,
          "bound_by": by, "ops": nops, "bytes": nbytes,
          "yardstick_cross_entropy_ms": yard_ms,
          "yardstick_max_abs_diff": ce_diff, "shape": [t, cfg.d_model,
                                                       head.shape[1]]}
    del hc, head
    out["parts_ms"] = train_parts(torch, fa, fce, optim, cfg, params, opt)
    del params, opt
    torch.cuda.empty_cache()

    diff, same, replayed = restart_drill(torch, tf, optim, data, runtime,
                                         smoke_cfg)
    out["restart_drill"] = {"steps": DRILL_STEPS, "ckpt_every": DRILL_EVERY,
                            "fail_at": DRILL_FAIL, "replayed": replayed,
                            "max_abs_param_diff": diff, "bit_equal": same,
                            "tolerance": DRILL_ATOL}
    return out, k6_launches, k5_launches, err, k6, k5_fn_err


def edge_cases(torch, ops, ref):
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    err = 0.0

    def put(a):
        return torch.from_numpy(a).to(dev)

    for lut in ("f32", "bf16", "int8"):
        for (nq, c, m, kc, k, masked) in ((9, 517, 8, 64, 12, 5),
                                          (5, 130, 16, 256, 40, 110),
                                          (33, 5003, 16, 256, 64, 700),
                                          (4, 300_000, 16, 256, 100, 0)):
            t = (rng.uniform(size=(nq, m, kc)) * 5).astype(np.float32)
            codes = rng.integers(0, kc, (nq, c, m)).astype(np.uint8)
            base = rng.uniform(size=(nq, c)).astype(np.float32)
            if masked:
                base[:, -masked:] = np.inf
                base[::2, :masked] = np.inf
            err = max(err, compare_k1(torch, ops, ref,
                                      f"edge {lut} Q={nq} C={c} M={m} k={k}",
                                      put(t), put(codes), put(base), k, lut,
                                      None))
    # exact int8 ties: integer tables, caller scale 1, constant base
    t = rng.integers(-3, 4, (6, 4, 8)).astype(np.float32)
    codes = rng.integers(0, 8, (6, 3000, 4)).astype(np.uint8)
    compare_k1(torch, ops, ref, "edge int8 exact ties", put(t), put(codes),
               put(np.zeros((6, 3000), np.float32)), 50, "int8",
               torch.ones(6, device=dev))
    return err


def compare_k2(torch, ops, name, tables, codes, k, lut, scale=None):
    """K2 against its plain version on the same CUDA tensors: d2 and ids
    bit-equal at every LUT type (the kernel adds the M terms from 0 in
    ascending m with __fadd_rn, the plain version's order; int8 sums are
    exact and take the scale once). Returns max |err|."""
    dk, ik = ops.pq_adc_topk(tables, codes, k, lut, scale)
    torch.cuda.synchronize()
    dp, ip = ops.pq_adc_topk_plain(tables, codes, k, lut, scale)
    fin = torch.isfinite(dp)
    check(torch.equal(torch.isfinite(dk), fin), f"{name}: finite mask")
    err = float((dk[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    check(torch.equal(dk, dp), f"{name}: d2 not bit-equal (max err {err})")
    check(torch.equal(ik, ip), f"{name}: ids differ")
    log(f"  {name}: ok, bit-equal")
    return err


def edge_cases_k2(torch, ops):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    err = 0.0

    def put(a):
        return torch.from_numpy(a).to(dev)

    for lut in LUTS:
        for (nq, n, m, kc, k) in ((9, 5003, 16, 256, 12),    # ragged N
                                  (5, 40, 16, 256, 64),      # k > N
                                  (1, 100_000, 16, 256, 64),  # Q = 1
                                  (13, 3000, 8, 64, 20),     # byte loads
                                  (4, 20_000, 16, 256, 1000),  # large k
                                  (16, N, 16, 256, 64)):     # N = 1M
            t = (rng.uniform(size=(nq, m, kc)) * 5).astype(np.float32)
            codes = rng.integers(0, kc, (n, m)).astype(np.uint8)
            err = max(err, compare_k2(torch, ops,
                                      f"K2 edge {lut} Q={nq} N={n} M={m} "
                                      f"k={k}", put(t), put(codes), k, lut))
    # exact int8 ties: integer tables, caller scale 1
    t = rng.integers(-3, 4, (6, 4, 8)).astype(np.float32)
    codes = rng.integers(0, 8, (3000, 4)).astype(np.uint8)
    dp, _ = ops.pq_adc_topk_plain(put(t), put(codes), 50, "int8",
                                  torch.ones(6, device=dev))
    check(int((dp[:, 1:] == dp[:, :-1]).sum()) > 50, "K2 ties are not real")
    compare_k2(torch, ops, "K2 edge int8 exact ties", put(t), put(codes),
               50, "int8", torch.ones(6, device=dev))
    return err


def compare_k4(torch, pw, name, p, tau):
    """K4 against its plain version: count and coeff equal (exact
    integers), sum within 1e-5 relative (the kernel adds in another order
    than torch.sum). Returns max |err| over sum and coeff."""
    ck, sk, fk = pw.pairwise_stats(p, tau)
    torch.cuda.synchronize()
    cp, sp, fp = pw.pairwise_stats_ref(p, tau)
    check(int(ck) == int(cp), f"{name}: count {int(ck)} != {int(cp)}")
    check(torch.equal(fk, fp), f"{name}: coeff differs")
    err = abs(float(sk) - float(sp))
    check(err <= 1e-5 * abs(float(sp)), f"{name}: sum {float(sk)} vs "
          f"{float(sp)}")
    log(f"  {name}: ok, count {int(ck)}, |sum err| {err:.3e}")
    return err


def edge_cases_k4(torch, pw):
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    err = 0.0
    for n in (1, 2, 1000, 2048, 2500, 20_000):
        for repeated in (False, True):
            p = (rng.integers(0, 20, n).astype(np.float32) if repeated
                 else rng.standard_normal(n).astype(np.float32))
            pd = torch.from_numpy(p).to(dev)
            for tau in (0.0, 0.5, float("inf")):
                err = max(err, compare_k4(
                    torch, pw, f"K4 edge N={n} repeated={repeated} "
                    f"tau={tau}", pd, torch.tensor(tau, device=dev)))
    return err


def k5_tolerance(dtype_name):
    """K5 against its plain version: the tolerances of
    tests/test_flash_attention.py. f32: the same f32 sums in another order
    (atol 2e-5, rtol 1e-4). bf16: both round one f32 result to bf16 once,
    so they differ by at most one bf16 ulp where the f32 sums straddle a
    rounding boundary (atol 3e-2: an ulp of values below 4)."""
    return (dict(atol=2e-5, rtol=1e-4) if dtype_name == "f32"
            else dict(atol=3e-2, rtol=0.0))


def compare_k5(torch, fa, name, q, k, v, window):
    """K5 against its plain version on the same CUDA tensors, at
    ``k5_tolerance``. Returns max |err|."""
    got = fa.flash_attention_fwd(q, k, v, window)
    torch.cuda.synchronize()
    want = fa.flash_attention_fwd_plain(q, k, v, window)
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"{name}: output {got.dtype} {tuple(got.shape)}")
    tol = k5_tolerance("f32" if q.dtype == torch.float32 else "bf16")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
    check(ok and bool(torch.isfinite(got).all()),
          f"{name}: beyond {tol} (max err {err})")
    log(f"  {name}: ok, max |err| {err:.3e}")
    return err


def k5_inputs(torch, seed, b, s, h, kv, dh, dtype):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to("cuda").to(dtype)
        for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)))


# (b, s, h, kv, dh, window): S = 1, 16, 80 (ragged), 4096; G = 1 and 8;
# dh = 8, 16, 32, 64, 128, 256; window 16 at S = 1000, wider than S, and 1
K5_EDGES = ((1, 1, 4, 4, 64, None), (2, 16, 8, 1, 8, None),
            (2, 80, 8, 1, 64, None), (1, 80, 4, 4, 128, None),
            (2, 80, 4, 2, 16, 24), (1, 4096, 32, 4, 64, None),
            (1, 1000, 4, 2, 64, 16), (1, 1000, 8, 4, 256, 16),
            (1, 300, 4, 1, 256, 1000), (1, 200, 8, 8, 32, 1),
            (1, 257, 4, 2, 128, 1))


def edge_cases_k5(torch, fa):
    err = 0.0
    for i, (b, s, h, kv, dh, win) in enumerate(K5_EDGES):
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = k5_inputs(torch, 10 + i, b, s, h, kv, dh, dt)
            err = max(err, compare_k5(
                torch, fa, f"K5 edge {name} B={b} S={s} H={h} KV={kv} "
                f"dh={dh} window={win}", q, k, v, win))
    # the LM shapes at full length, bf16, against the chunked plain version:
    # TinyLlama at prefill_32k's sequence (batch 32 cut to 1), and
    # Gemma3-4B's local layers (H 8 / KV 4 / dh 256, window 1024)
    for name, (b, s, h, kv, dh, win) in (
            ("tinyllama S=32768", (1, 32768, 32, 4, 64, None)),
            ("gemma3-4b local S=8192", (1, 8192, 8, 4, 256, 1024))):
        q, k, v = k5_inputs(torch, 7, b, s, h, kv, dh, torch.bfloat16)
        err = max(err, compare_k5(torch, fa, f"K5 edge bf16 {name}", q, k, v,
                                  win))
    return err


def k5_bound(b, s, h, kv, dh, window, elem_bytes):
    """The least time of one K5 call: the larger of its operations (a
    multiply-add of q.k and of p.v per head dim per (query, key) pair the
    mask keeps) at the bf16 tensor peak and its bytes (q, k, v read once,
    the output written once) at the HBM rate. Returns (ms, by, ops, bytes)."""
    w = s if window is None else min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w     # causal, within the window
    nops = 4 * dh * pairs * b * h
    nbytes = (2 * b * s * h * dh + 2 * b * s * kv * dh) * elem_bytes
    t_ops, t_bytes = nops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nops, nbytes)


def search_timed(torch, eng, qd, batches):
    """Searches at each batch: 2 warm-up calls, then 20 timed by CUDA
    events. Returns ({batch: latency stats}, {batch: ids})."""
    lat, found = {}, {}
    for b in batches:
        qb = qd[:b]
        for _ in range(2):                                # warm-up
            eng.search(qb, K)
        times = []
        for _ in range(20):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            d, i = eng.search(qb, K)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        found[b] = i
        lat[b] = {"p50_ms": float(np.median(times)),
                  "p90_ms": float(np.percentile(times, 90)),
                  "qps": b / (float(np.median(times)) / 1e3),
                  "bucket": eng.last_bucket}
        check(tuple(d.shape) == (b, K) and bool(torch.isfinite(d).all())
              and bool((i >= 0).all()) and bool((i < N).all()),
              f"batch {b}: bad result shape or values")
    return lat, found


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch._device import cpu_generator
        from repro_torch.core import MPADConfig, fast_objective
        from repro_torch.core.objective import num_selected_pairs
        from repro_torch.configs import lm_param_count
        from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import mpad_pairwise as pw
        from repro_torch.kernels.pq_adc import ops, ref
        from repro_torch.kernels.pq_adc.lut import center_lut
        from repro_torch.search import ivfpq, knn
        from repro_torch.search import (SearchEngine, build_engine,
                                        recall_at_k)
        from repro_torch.search.ivf import probe_cells
        from repro_torch.search.pq import adc_tables
        from repro_torch.search.registry import (BuildInits, Index,
                                                 ScanParams, get_ops)
        from repro_torch.search.reducers import reduce_vectors
        from repro_torch.search.serve import (EngineState, config_from_spec,
                                              exact_rerank)
        from repro_torch.search.spec import parse_spec
        from repro_torch.models import transformer as tf
        from repro_torch.models.layers import rms_norm
        from repro_torch.configs.tinyllama_1_1b import SMOKE as TINY_SMOKE
        from repro_torch.kernels import fused_ce as fce
        from repro_torch import data, optim, runtime
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wall0 = time.perf_counter()
    result = {"spec": SPEC, "spec_pq": SPEC_PQ, "spec_opq": SPEC_OPQ,
              "n": N, "dim": DIM, "seed": SEED}

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(smi)
    result["card"] = smi

    # 2. build
    t0 = time.perf_counter()
    build.build_libraries(verbose=True)
    result["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(build.SOURCES)} kernel libraries built in "
        f"{result['build_s']:.2f} s")

    # 3. each kernel on edge cases
    log("[K1 edges]")
    max_err = edge_cases(torch, ops, ref)
    log("[K2 edges]")
    k2_err = edge_cases_k2(torch, ops)
    log("[K4 edges]")
    k4_err = edge_cases_k4(torch, pw)
    log("[K5 edges]")
    k5_err = edge_cases_k5(torch, fa)
    log("[K6 edges]")
    k6_err = edge_cases_k6(torch, fce)
    torch.cuda.synchronize()

    # 4. the main path
    t0 = time.perf_counter()
    x = clustered_corpus(N, DIM, SEED)
    q_all = clustered_corpus(max(BATCHES), DIM, SEED + 1)
    log(f"[main] corpus {x.shape} made in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    xd = torch.from_numpy(x).to(dev)
    qd = torch.from_numpy(q_all).to(dev)
    del x
    counters = (ops.pq_adc_gather_topk, ops.pq_adc_topk, pw.pairwise_stats,
                fa.flash_attention_fwd, fce.fused_ce_fwd)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    eng = build_engine(xd, SPEC, device=dev, seed=SEED)
    torch.cuda.synchronize()
    result["engine_build_s"] = time.perf_counter() - t0
    result["build_stages_s"] = eng.build_seconds
    lists = eng.state.index.payload.lists
    result["max_cell"] = int(lists.shape[1])
    log(f"[main] build_engine {result['engine_build_s']:.1f} s, stages "
        f"{ {k: round(v, 2) for k, v in eng.build_seconds.items()} }, "
        f"max_cell {result['max_cell']}")
    lat, found = search_timed(torch, eng, qd, BATCHES)
    launches = ops.pq_adc_gather_topk.launches
    result["latency"] = lat
    result["k1_launches"] = launches
    log(f"[main] K1 launches in the main path: {launches}")
    check(launches > 0, "K1 never launched on the main path")
    _, truth = knn.knn_scan(qd, xd, K)
    rec = {b: recall_at_k(found[b], truth[:b]) for b in BATCHES}
    result["recall_at_10"] = rec
    for b in BATCHES:
        log(f"[main] batch {b:4d}: p50 {lat[b]['p50_ms']:.3f} ms "
            f"p90 {lat[b]['p90_ms']:.3f} ms qps {lat[b]['qps']:.0f} "
            f"recall@10 {rec[b]:.4f}")
    check(rec[256] >= RECALL_FLOOR, f"recall@10 {rec[256]} < {RECALL_FLOOR}")
    jeng = SearchEngine.from_state(
        eng.state, dataclasses.replace(eng.config, pq_backend="jnp"))
    _, ij = jeng.search(qd, K)
    check(torch.equal(ij, found[256]), "@jnp and @kernel ids differ")
    log("[main] @jnp returns the @kernel ids at batch 256")

    # 5. K1 against its plain version on the main path's scan inputs
    state = eng.state
    ix = state.index.payload
    cfg = eng.config
    qr = reduce_vectors(state.proj, qd)
    probe, cand, cd2p = probe_cells(ix.centroids, ix.lists, qr, cfg.nprobe,
                                    cfg.rerank)
    ccodes, base = ivfpq.ivfpq_scan_inputs(probe, cand, cd2p, ix.codes_cell,
                                           ix.bias_cell)
    tables = adc_tables(ix.lut_w, ix.cbnorm, qr)
    center, scale = ivfpq.ivfpq_lut_stats(ix.codebooks, ix.cbnorm, qr, "int8")
    kt = tables - center[:, :, None]
    k_eff = min(cfg.rerank, cand.shape[1])
    c = int(cand.shape[1])
    result["scan_shape"] = {"Q": 256, "C": c, "M": int(ix.codes_cell.shape[2]),
                            "K": int(ix.cbnorm.shape[1]), "k": k_eff}
    log(f"[K1 main] scan shape {result['scan_shape']}")
    for lut in ("f32", "bf16"):
        max_err = max(max_err, compare_k1(torch, ops, ref, f"main {lut}",
                                          tables, ccodes, base, k_eff, lut,
                                          None))
    max_err = max(max_err, compare_k1(torch, ops, ref, "main int8", kt,
                                      ccodes, base, k_eff, "int8", scale))

    # 6. timings at batch 256 (int8, the main path's LUT)
    k1_ms = cuda_ms(torch, lambda: ops.pq_adc_gather_topk(
        kt, ccodes, base, k_eff, "int8", scale), reps=20)
    plain_ms = cuda_ms(torch, lambda: ops.pq_adc_gather_topk_plain(
        kt, ccodes, base, k_eff, "int8", scale), reps=5, warmup=1)
    m_, kc_ = result["scan_shape"]["M"], result["scan_shape"]["K"]
    nbytes = (256 * c * m_                  # codes, uint8
              + 256 * c * 4                 # base, f32
              + 256 * m_ * kc_ * 4          # tables, f32 (quantized inside)
              + 256 * 4                     # scale
              + 256 * k_eff * 8)            # (d2, slot) out
    nops = 256 * c * (m_ + 2)               # M adds + one fma per candidate
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= nops / F32_OPS_PER_S
                else "operations")
    log(f"[timings] K1 {k1_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, {nops} ops); no single "
        "PyTorch call computes K1, so no library time")

    def stage(fn):
        return cuda_ms(torch, fn, reps=10)

    _, scan_cand = get_ops(cfg.index).scan(state, qr, cfg.rerank, ScanParams(
        nprobe=cfg.nprobe, backend="kernel", lut_dtype=cfg.lut_dtype))

    stages = {
        "project": stage(lambda: reduce_vectors(state.proj, qd)),
        "probe": stage(lambda: probe_cells(ix.centroids, ix.lists, qr,
                                           cfg.nprobe, cfg.rerank)),
        "lut": stage(lambda: (adc_tables(ix.lut_w, ix.cbnorm, qr),
                              ivfpq.ivfpq_lut_stats(ix.codebooks, ix.cbnorm,
                                                    qr, "int8"))),
        "gather": stage(lambda: ivfpq.ivfpq_scan_inputs(
            probe, cand, cd2p, ix.codes_cell, ix.bias_cell)),
        "adc_k1": k1_ms,
        "rerank": stage(lambda: exact_rerank(qd, state.corpus, scan_cand,
                                             K)),
    }
    result["stages_ms_batch256"] = stages
    log(f"[timings] stages at batch 256 (ms): "
        f"{ {k: round(v, 4) for k, v in stages.items()} }")

    # 7. device busy share of the search path (torch.profiler)
    result["device_busy"] = {b: device_busy(torch, eng, qd[:b], f"batch {b}")
                             for b in (1, 256)}

    # 8. path 2: pq with the QPAD fit on K4, then opq on the same reducer
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    eng_pq = build_engine(xd, SPEC_PQ, device=dev, seed=SEED,
                          fit_sample=FIT_SAMPLE,
                          mpad=MPADConfig(**FIT, backend="kernel"))
    torch.cuda.synchronize()
    result["pq_engine_build_s"] = time.perf_counter() - t0
    result["pq_build_stages_s"] = eng_pq.build_seconds
    k4_launches = pw.pairwise_stats.launches
    result["k4_launches_fit"] = k4_launches
    log(f"[path 2] build_engine({SPEC_PQ}) "
        f"{result['pq_engine_build_s']:.1f} s, stages "
        f"{ {k: round(v, 2) for k, v in eng_pq.build_seconds.items()} }; "
        f"K4 launches in the fit: {k4_launches}")
    check(k4_launches == FIT["m"] * FIT["iters"],
          f"the kernel-backend fit launched K4 {k4_launches} times, not "
          f"{FIT['m'] * FIT['iters']}")
    check(ops.pq_adc_topk.launches == 0 and
          ops.pq_adc_gather_topk.launches == 0, "a scan kernel ran in a build")
    proj = eng_pq.state.proj
    reduced = reduce_vectors(proj, xd)
    t0 = time.perf_counter()
    opq_payload = get_ops("opq").build(reduced, parse_spec(SPEC_OPQ),
                                       cpu_generator(SEED), BuildInits())
    torch.cuda.synchronize()
    result["opq_index_build_s"] = time.perf_counter() - t0
    eng_opq = SearchEngine.from_state(
        EngineState(corpus=xd, proj=proj, index=Index("opq", opq_payload)),
        config_from_spec(SPEC_OPQ))
    log(f"[path 2] opq index over the same reduced corpus in "
        f"{result['opq_index_build_s']:.1f} s")
    del reduced
    for fn in counters:
        fn.launches = 0
    lat2, found2 = {}, {}
    for name, e in (("pq", eng_pq), ("opq", eng_opq)):
        lat2[name], found2[name] = search_timed(torch, e, qd, BATCHES)
    k2_launches = ops.pq_adc_topk.launches
    result["k2_launches_search"] = k2_launches
    log(f"[path 2] K2 launches in the searches: {k2_launches}")
    check(k2_launches > 0, "K2 never launched on path 2")
    check(ops.pq_adc_gather_topk.launches == 0, "K1 ran on path 2")
    rec2 = {name: {b: recall_at_k(found2[name][b], truth[:b])
                   for b in BATCHES} for name in found2}
    result["path2_latency"] = lat2
    result["path2_recall_at_10"] = rec2
    for name in ("pq", "opq"):
        for b in BATCHES:
            lt = lat2[name][b]
            log(f"[path 2] {name:3s} batch {b:4d}: p50 {lt['p50_ms']:.3f} "
                f"ms p90 {lt['p90_ms']:.3f} ms qps {lt['qps']:.0f} "
                f"recall@10 {rec2[name][b]:.4f}")
        check(rec2[name][256] >= RECALL_FLOOR,
              f"{name} recall@10 {rec2[name][256]} < {RECALL_FLOOR}")
        e = eng_pq if name == "pq" else eng_opq
        je = SearchEngine.from_state(
            e.state, dataclasses.replace(e.config, pq_backend="jnp"))
        _, ij = je.search(qd, K)
        check(torch.equal(ij, found2[name][256]),
              f"{name}: @jnp and @kernel ids differ")
        log(f"[path 2] {name}: @jnp returns the @kernel ids at batch 256")

    # 9. K2 on path 2's own tables and codes; K4's phi on the fit sample
    log("[K2 main]")
    pix = eng_pq.state.index.payload
    qr2 = reduce_vectors(proj, qd)
    t32 = adc_tables(pix.lut_w, pix.cbnorm, qr2)
    tc, _ = center_lut(t32)                  # pq_scan centers bf16 / int8
    for lut, t in (("f32", t32), ("bf16", tc), ("int8", tc)):
        k2_err = max(k2_err, compare_k2(torch, ops, f"K2 main {lut}", t,
                                        pix.codes, RERANK, lut))
    log("[K4 main]")
    gen = cpu_generator(SEED)
    rows = torch.randperm(N, generator=gen)[:FIT_SAMPLE].to(dev)
    sample = xd[rows]
    xs = sample - sample.mean(dim=0)
    rng = np.random.default_rng(4)
    prev = torch.zeros((FIT["m"], DIM), device=dev)
    mask = torch.zeros(FIT["m"], device=dev)
    phi_err = {"value_rel": 0.0, "grad_abs": 0.0}
    for j in range(3):
        w = torch.from_numpy(rng.standard_normal(DIM).astype(np.float32))
        w = (w / w.norm()).to(dev)
        vk, gk = pw.phi_kernel_value_and_grad(w, xs, prev, mask,
                                              b=FIT["b"], alpha=FIT["alpha"])
        vf, gf = fast_objective.phi_fast_value_and_grad(
            w, xs, prev, mask, b=FIT["b"], alpha=FIT["alpha"])
        rel = abs(float(vk) - float(vf)) / abs(float(vf))
        gerr = float((gk - gf).abs().max())
        check(rel <= 1e-5, f"phi value {float(vk)} vs fast {float(vf)}")
        check(torch.allclose(gk, gf, rtol=1e-4, atol=1e-5),
              f"phi gradient differs from fast (max {gerr})")
        phi_err = {"value_rel": max(phi_err["value_rel"], rel),
                   "grad_abs": max(phi_err["grad_abs"], gerr)}
        prev[j] = w                          # later draws pay the penalty
        mask[j] = 1.0
    result["phi_kernel_vs_fast"] = phi_err
    log(f"[K4 main] phi kernel vs fast on the fit sample: {phi_err}")

    # 10. timings: K2 at batch 256, K4 at the fit's N, path 2's searches
    m2, kc2 = pix.cbnorm.shape
    k2_ms = cuda_ms(torch, lambda: ops.pq_adc_topk(
        tc, pix.codes, RERANK, "int8"), reps=10)
    k2_plain_ms = cuda_ms(torch, lambda: ops.pq_adc_topk_plain(
        tc, pix.codes, RERANK, "int8"), reps=3, warmup=1)
    k2_bytes = (N * m2                      # codes, uint8
                + 256 * m2 * kc2 * 4        # tables, f32 (quantized inside)
                + 256 * RERANK * 8)         # (d2, row) out
    k2_ops = 256 * N * (m2 + 1)             # M adds + one rescale per row
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / F32_OPS_PER_S) * 1e3
    k2_by = ("bytes" if k2_bytes / HBM_BYTES_PER_S >= k2_ops / F32_OPS_PER_S
             else "operations")
    log(f"[timings] K2 {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, bound "
        f"{k2_bound:.4f} ms ({k2_by}: {k2_bytes} B, {k2_ops} ops) at Q=256 "
        f"N={N} M={m2} K={kc2} k={RERANK} int8; no single PyTorch call "
        "computes K2, so no library time")
    p = xs @ w
    tau = fast_objective.find_quantile_threshold(
        p, num_selected_pairs(FIT_SAMPLE, FIT["b"]))  # the fit's threshold
    k4_ms = device_ms(torch, lambda: pw.pairwise_stats(p, tau), reps=200,
                      match="pair_")
    k4_call_ms = cuda_ms(torch, lambda: pw.pairwise_stats(p, tau), reps=200)
    k4_plain_ms = cuda_ms(torch, lambda: pw.pairwise_stats_ref(p, tau),
                          reps=20)
    n4 = FIT_SAMPLE
    k4_bytes = n4 * 4 + 4 + n4 * 4 + 8 + 4   # p, tau in; coeff, count, sum
    k4_ops = 5 * n4 * (n4 - 1)              # sub, abs, compare, 2 adds a pair
    k4_bound = max(k4_bytes / HBM_BYTES_PER_S, k4_ops / F32_OPS_PER_S) * 1e3
    k4_by = ("bytes" if k4_bytes / HBM_BYTES_PER_S >= k4_ops / F32_OPS_PER_S
             else "operations")
    log(f"[timings] K4 {k4_ms:.4f} ms on the card ({k4_call_ms:.4f} ms a "
        f"call back to back), plain {k4_plain_ms:.4f} ms, bound "
        f"{k4_bound:.6f} ms ({k4_by}: {k4_bytes} B, {k4_ops} ops) at "
        f"N={n4}; no single PyTorch call computes K4, so no library time")
    result["k2_timing"] = {"ms": k2_ms, "plain_ms": k2_plain_ms,
                           "bound_ms": k2_bound}
    result["k4_timing"] = {"ms": k4_ms, "call_ms": k4_call_ms,
                           "plain_ms": k4_plain_ms, "bound_ms": k4_bound}
    log(f"[timings] path 2 pq build stages (s): "
        f"{ {k: round(v, 3) for k, v in eng_pq.build_seconds.items()} }")

    def host_ms(fn, reps=50):
        """Host time of ``fn()``, synchronized, in ms a call."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def step(phi_vg):
        return lambda: phi_vg(w, xs, prev, mask, b=FIT["b"],
                              alpha=FIT["alpha"])

    # one fit step's objective on each backend, and its shared threshold
    # bisection alone
    k_pairs = num_selected_pairs(FIT_SAMPLE, FIT["b"])
    steps = {"fast": host_ms(step(fast_objective.phi_fast_value_and_grad)),
             "kernel": host_ms(step(pw.phi_kernel_value_and_grad)),
             "threshold": host_ms(
                 lambda: fast_objective.find_quantile_threshold(p, k_pairs))}
    result["phi_step_ms"] = steps
    log(f"[timings] one fit step's objective, host ms: "
        f"{ {k: round(v, 3) for k, v in steps.items()} }")
    result["path2_device_busy"] = {
        b: device_busy(torch, eng_pq, qd[:b], f"pq batch {b}")
        for b in (1, 256)}

    # 11-14. path 3: the LM serving path on K5
    lm, k5_launches, k5_main_err, k5 = lm_path(
        torch, tf, fa, lm_param_count, rms_norm, TINYLLAMA, counters)
    result["path3"] = lm
    result["k5_timing"] = k5
    k5_err = max(k5_err, k5_main_err)

    # 15-19. path 4: the LM training path on K5 (forward + Function) and K6
    del eng, jeng, eng_pq, eng_opq, je, e, state, ix, pix, xd, sample, xs
    torch.cuda.empty_cache()
    train, k6_launches, k5_train_launches, k6_main_err, k6, k5_fn_err = \
        train_path(torch, (tf, fa, fce, optim, data, runtime, lm_param_count),
                   TINYLLAMA, TINY_SMOKE, counters)
    result["path4"] = train
    result["path4"]["k5_function_max_rel_err"] = k5_fn_err
    result["k6_timing"] = k6
    k6_err = max(k6_err, k6_main_err)

    kernels = [{
        "name": "pq_adc_gather_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/pq_adc/csrc/pq_adc_gather_topk.cu",
        "replaces": "src/repro/kernels/pq_adc/kernel.py:212",
        "launches": launches, "max_abs_err": max_err, "ms": k1_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}, {
        "name": "pq_adc_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/pq_adc/csrc/pq_adc_topk.cu",
        "replaces": "src/repro/kernels/pq_adc/kernel.py:120",
        "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": None}, {
        "name": "pairwise_stats", "route": "cuda",
        "source": "src/repro_torch/kernels/mpad_pairwise/csrc/"
                  "pairwise_stats.cu",
        "replaces": "src/repro/kernels/mpad_pairwise/kernel.py:64",
        "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms,
        "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
        "library_ms": None}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "launches": k5_launches, "max_abs_err": k5_err, "ms": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], "library_ms": k5["library_ms"],
        "note": "forward + autograd.Function; launches: path 3's prefill "
                "and decode; launches_path4: path 4's training steps",
        "launches_path4": k5_train_launches}, {
        "name": "fused_ce_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_ce/csrc/fused_ce_fwd.cu",
        "replaces": "src/repro/kernels/fused_ce/kernel.py:64",
        "launches": k6_launches, "max_abs_err": k6_err, "ms": k6["ms"],
        "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"], "library_ms": None}]
    result["wall_s"] = time.perf_counter() - wall0
    log(f"[done] wall time {result['wall_s']:.1f} s")
    print(json.dumps({"result": result}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
