#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits nonzero; no phase's failure is caught):
  1. device   CUDA must be present; prints the card's name and power limit.
  2. build    builds every CUDA kernel of the port (K1, K2, K4, K5) from the
              checkout's sources, one nvcc per source, all at once
              (sm_90a), and times the build.
  3. edges    each kernel against its plain PyTorch version on edge
              cases. K1: ragged C, masked slots, k > #finite, exact int8
              ties, a deep merge. K2: ragged N, k > N, Q = 1, M not a
              multiple of 16, a large k, exact int8 ties, N = 1,000,000.
              K4: N = 1, 2, ragged N, N = 2048, a multi-tile N, repeated
              values, tau = 0 and tau = +inf. K5 (f32 and bf16): S = 1,
              16, 80 (ragged), 4096; G = 1 and 8; dh = 8 to 256; window
              16 at S = 1000, a window wider than S, window 1; and at bf16
              TinyLlama's heads at S = 32768 and Gemma3-4B's local layers
              (H 8 / KV 4 / dh 256, window 1024) at S = 8192.
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

Before those, one line {"result": {...}} holds every measurement of the
run. The line before the last is {"kernels": [...]}; the last line is
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


def busy_share(torch, fn, reps, label):
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
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    out = {"busy_share": busy_us / wall_us,
           "kernels_per_call": sum(e.count for e in kern) / reps,
           "top_kernels_us": [(e.key[:60], e.self_device_time_total / reps)
                              for e in top]}
    log(f"[trace] {label}: device busy {out['busy_share']:.3f} of the "
        f"window, {out['kernels_per_call']:.0f} kernels a call; top kernels "
        f"(us per call): "
        f"{[(n, round(t, 1)) for n, t in out['top_kernels_us']]}")
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
                fa.flash_attention_fwd)
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
        "bound_by": k5["bound_by"], "library_ms": k5["library_ms"]}]
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
