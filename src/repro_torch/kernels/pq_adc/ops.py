"""Wrappers of the ADC top-k kernels: K1 (ADC top-k over per-query
candidates, in two entries: ``pq_adc_gather_topk`` over gathered codes
(Q, C, M), and ``pq_adc_cells_topk`` over an IVF-PQ index's probed cells
read where they lie) and K2 (ADC top-k over one shared code matrix;
``pq_adc_topk_global`` runs it over one shard's row block of sharded
serving and returns global row ids).

Each wrapper takes its plain PyTorch version (``ref.py``) for tensors on
the CPU, and only for those; for CUDA tensors it launches its CUDA kernel
(``csrc/``) or raises. Each launch adds one to the wrapper's ``launches``
(each K1 entry has its own). K1's and K2's blocks split their candidates
over a second grid axis by a plan made from the kernel's occupancy
(``pq_adc_select_plan``, ``pq_adc_topk_plan``; cached per shape).

Contract (both routes): (d2 (Q, k) f32 ascending, slot or row (Q, k)
int64) with ties to the lower slot and (+inf, -1) where fewer than k
candidates are finite (k above the candidate count pads the same way).

K2 reads its tables in a layout this module makes: ``shared_layout``
picks the queries a block serves (QB: up to 32 with int8 tables, 8 with
f32 and bf16) and how an entry is staged, ``pack_shared_tables`` packs
the quantized tables query-interleaved, [group][m][code][qi], so that one
shared-memory load serves all QB queries of a block (8 of them a lane in
an int8 group of 32, whose four lanes a row each load a quarter of the
entry vector), and ``packed_scores`` is the plain scorer over that
layout, with the kernel's arithmetic (int8 as biased bytes summed in
16-bit lanes, flushed into int32 every 256 terms). ``shared_smem_bytes``
is a block's shared memory as the kernel counts it; the kernel checks the
group size it is handed and refuses a call past the Hopper limit. K2
counts its launches by QB in ``pq_adc_topk.launches_by_qb``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.search.knn import topk_smallest

from .build import gather_topk_library, topk_library
from .lut import LUT_DTYPES, quantize_lut
from .ref import (gather_cells, live_slots, pq_adc_gather_topk_ref,
                  pq_adc_topk_ref)

__all__ = ["pq_adc_gather_topk", "pq_adc_gather_topk_plain",
           "pq_adc_cells_topk", "pq_adc_cells_topk_plain",
           "pq_adc_select_plan", "pq_adc_topk", "pq_adc_topk_plain",
           "pq_adc_topk_global", "pq_adc_topk_global_plain",
           "pq_adc_topk_plan", "shared_layout", "pack_shared_tables",
           "packed_scores", "shared_smem_bytes", "list_work", "MAX_K"]

MAX_K = 8192                     # the kernels' largest chunk holds 2k pairs
_LUT_MODE = {"f32": 0, "bf16": 1, "int8": 2}
_SMEM_LIMIT = 232_448            # bytes of shared memory a Hopper block may use

# K2's staged table entries: the kernel's Entry modes and their bytes
ENTRY_MODES = {"f32": 0, "bf16": 1, "uint8": 2}
_ENTRY_BYTES = {"f32": 4, "bf16": 2, "uint8": 1}
_ENTRY = {"f32": "f32", "bf16": "bf16", "int8": "uint8"}
U8_BIAS = 128            # an int8 entry q is staged as the byte q + 128
LANE_FLUSH = 256         # terms a 16-bit lane sums exactly (256 * 255 < 2^16)
MAX_QB = 8               # queries a K2 block serves at most (f32, bf16)
MAX_QB_U8 = 32           # ... with int8 tables (biased-byte entries)
LIST_MIN_WORK = 512      # K2's list room a query: k best + newcomers (pow2)
LIST_MIN_WORK_32 = 256   # ... in a group of 32 (its tables fill the rest)
# (query, row) pairs a K2 call scans before int8 groups of more than 8
# queries pay: such a group fills an SM with one block, whose set-up (the
# tables staged, the lists sorted) a short row part does not repay (on the
# card: 18% slower at Q 256 over 1M rows, 9% faster at Q 1,024 over 1M and
# 13% at Q 1,024 over 5M; PERF.md)
WIDE_MIN_PAIRS = 1 << 29


def _pad_contract(d2, idx, k):
    """(+inf, -1) in unfilled slots and right-padding up to k."""
    idx = torch.where(d2 == float("inf"), -1, idx)
    if d2.shape[1] < k:
        pad = k - d2.shape[1]
        d2 = torch.nn.functional.pad(d2, (0, pad), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return d2, idx


def pq_adc_gather_topk_plain(tables, codes, base, k, lut_dtype="f32",
                             scale=None):
    """K1's plain PyTorch version under the kernel's contract: ``ref.py``'s
    top-k, with (+inf, -1) in unfilled slots and k > C padded. Runs on any
    device; the wrapper takes it for CPU tensors."""
    d2, slot = pq_adc_gather_topk_ref(tables, codes, base,
                                      min(k, codes.shape[1]), lut_dtype,
                                      scale)
    return _pad_contract(d2, slot, k)


def pq_adc_topk_plain(tables, codes, k, lut_dtype="f32", scale=None):
    """K2's plain PyTorch version under the kernel's contract: ``ref.py``'s
    shared-codes top-k, with (+inf, -1) in unfilled slots and k > N
    padded. Runs on any device; the wrapper takes it for CPU tensors."""
    d2, row = pq_adc_topk_ref(tables, codes, min(k, codes.shape[0]),
                              lut_dtype, scale)
    return _pad_contract(d2, row, k)


def _check_common(tables, k, lut_dtype, scale, *others):
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"unknown lut_dtype {lut_dtype!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    devs = {t.device for t in (tables, *others)}
    if scale is not None:
        devs.add(torch.as_tensor(scale).device)
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


_CODE_DTYPES = (torch.uint8, torch.int32)


def _check_cuda_codes(tables, codes):
    """What both kernels take: CUDA tensors, contiguous uint8 codes (K <=
    256) or int32 codes (K > 256)."""
    if tables.device.type != "cuda":
        raise ValueError(f"no kernel for device {tables.device}")
    if codes.dtype not in _CODE_DTYPES:
        raise TypeError(f"codes must be uint8 or int32, got {codes.dtype}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")


def _check_smem(smem, m, kc, k):
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a (M={m}, K={kc}) table with k={k} needs {smem} "
                         f"bytes of shared memory (limit {_SMEM_LIMIT})")


def _empty(nq, k, dev):
    return (torch.full((nq, k), float("inf"), dtype=torch.float32,
                       device=dev),
            torch.full((nq, k), -1, dtype=torch.int64, device=dev))


def _quantized(tables, lut_dtype, scale):
    qt, s = quantize_lut(tables, lut_dtype, scale)
    return qt.contiguous(), s.to(torch.float32).contiguous()


def list_work(k: int, qb: int = 1) -> int:
    """K2's list a query in a group of ``qb`` queries, in (key, row)
    pairs: a power of two >= 2k and >= LIST_MIN_WORK, or >=
    LIST_MIN_WORK_32 in a group of 32 (whose tables leave room for 256
    pairs a query at k <= 128; the kernel's warp_sort256). Its first k
    pairs are the query's k best, the other (work - k) the room where rows
    that beat the k-th wait for a sort."""
    w = LIST_MIN_WORK_32 if qb > 16 else LIST_MIN_WORK
    while w < 2 * k:
        w <<= 1
    return w


def _table_bytes(entry: str, qb: int, m: int, kc: int) -> int:
    """Bytes of one group's packed tables, padded to 16."""
    return -(-qb * m * kc * _ENTRY_BYTES[entry] // 16) * 16


def shared_smem_bytes(entry: str, qb: int, m: int, kc: int, k: int) -> int:
    """Shared memory of one K2 block: the group's packed tables, QB lists
    of ``list_work(k, qb)`` pairs and max(QB, 16) counters (the kernel's
    smem_bytes)."""
    return (_table_bytes(entry, qb, m, kc) + qb * 8 * list_work(k, qb)
            + 4 * max(qb, 16))


def shared_layout(nq: int, m: int, kc: int, k: int, lut_dtype: str,
                  n_rows: int):
    """K2's layout for a call over ``n_rows`` code rows: (QB, entry). QB
    starts at the next power of two >= nq, at most 32 with int8 tables
    (MAX_QB_U8) where the call scans at least WIDE_MIN_PAIRS (query, row)
    pairs, else at most 8 (MAX_QB), and halves while the group's tables and
    lists do not fit a block's shared memory (an int8 group of 32 at M 16,
    K 256 fits up to k 128). The entry is f32 / bf16 as the LUT is, and
    int8 as a biased byte ("uint8")."""
    entry = _ENTRY[lut_dtype]
    wide = entry == "uint8" and nq * n_rows >= WIDE_MIN_PAIRS
    top = MAX_QB_U8 if wide else MAX_QB
    qb = 1
    while qb < min(top, nq):
        qb <<= 1
    while qb > 1 and shared_smem_bytes(entry, qb, m, kc, k) > _SMEM_LIMIT:
        qb >>= 1
    return qb, entry


def pack_shared_tables(tables_q: torch.Tensor, lut_dtype: str,
                       qb: int) -> torch.Tensor:
    """Quantized (Q, M, K) tables (``quantize_lut``'s: f32, bf16 or int8)
    in K2's staged layout: (G, M, K, QB) with G = ceil(Q / QB) groups, the
    QB queries of a group interleaved innermost, so that the entries of
    one (m, code) are one vector (8 queries: 8 bytes of int8, 16 of bf16,
    32 of f32; 32 queries: 32 bytes of int8). QB is 1, 2, 4, 8, 16 or 32.
    f32 and bf16 stay as they are; int8 entries q become the
    bytes q + U8_BIAS in [1, 255] (the int8 bits with the sign bit
    flipped, one elementwise op). Absent queries of the last group hold
    entries that score 0."""
    want = {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[lut_dtype]
    if tables_q.dtype != want:
        raise TypeError(f"{lut_dtype} tables must be {want}, got "
                        f"{tables_q.dtype}")
    if qb not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"no K2 layout for QB {qb}")
    nq, m, kc = tables_q.shape
    g = -(-nq // qb)
    t = tables_q
    fill = 0
    if lut_dtype == "int8":
        t = t.view(torch.uint8) ^ U8_BIAS
        fill = U8_BIAS
    pad = g * qb - nq
    if pad:
        t = torch.cat([t, torch.full((pad, m, kc), fill, dtype=t.dtype,
                                     device=t.device)])
    return t.reshape(g, qb, m, kc).permute(0, 2, 3, 1).contiguous()


def packed_scores(packed: torch.Tensor, scale: torch.Tensor,
                  codes: torch.Tensor, lut_dtype: str,
                  nq: int) -> torch.Tensor:
    """The plain scorer over ``pack_shared_tables``'s layout, with K2's
    arithmetic: f32 and bf16 entries added in f32 from 0 in ascending m;
    int8's biased bytes summed in 16-bit lanes for at most LANE_FLUSH
    terms at a time (each lane sum checked to fit 16 bits), flushed into
    int32 with the bias taken off, then one f32 multiply by the scale.
    Returns (nq, N) f32."""
    g, m, kc, qb = packed.shape
    t = packed.permute(0, 3, 1, 2).reshape(g * qb, m, kc)[:nq]
    idx = codes.to(torch.int64)
    n = codes.shape[0]
    if lut_dtype in ("f32", "bf16"):
        d = torch.zeros((nq, n), dtype=torch.float32, device=packed.device)
        for j in range(m):
            d.add_(t[:, j, :].float().index_select(1, idx[:, j]))
        return d
    acc = torch.zeros((nq, n), dtype=torch.int32, device=packed.device)
    for m0 in range(0, m, LANE_FLUSH):
        mc = min(LANE_FLUSH, m - m0)
        lane = torch.zeros((nq, n), dtype=torch.int32, device=packed.device)
        for j in range(m0, m0 + mc):
            lane.add_(t[:, j, :].to(torch.int32).index_select(1, idx[:, j]))
        if int(lane.max()) >= 1 << 16:
            raise AssertionError("a 16-bit lane overflowed")
        acc.add_(lane - U8_BIAS * mc)
    return acc.to(torch.float32) * scale.to(torch.float32)[:, None]


def pq_adc_gather_topk(tables: torch.Tensor, codes: torch.Tensor,
                       base: torch.Tensor, k: int, lut_dtype: str = "f32",
                       scale=None):
    """Fused ADC scan over per-query candidate codes plus top-k (K1).

    tables (Q, M, K) f32, quantized here per ``lut_dtype`` with
    ``quantize_lut`` (``scale`` optionally overrides the per-query int8
    scale with a caller-certified bound); codes (Q, C, M) uint8 (int32
    for K > 256); base (Q, C) f32, +inf masking pads. Returns (d2 (Q, k)
    f32, slot (Q, k) int64).
    """
    _check_common(tables, k, lut_dtype, scale, codes, base)
    if tables.ndim != 3 or codes.ndim != 3 or base.ndim != 2:
        raise ValueError("expected tables (Q, M, K), codes (Q, C, M), "
                         "base (Q, C)")
    nq, m, kc = tables.shape
    if codes.shape[0] != nq or codes.shape[2] != m or \
            tuple(base.shape) != tuple(codes.shape[:2]):
        raise ValueError(f"shape mismatch: tables {tuple(tables.shape)}, "
                         f"codes {tuple(codes.shape)}, base "
                         f"{tuple(base.shape)}")
    if tables.device.type == "cpu":
        return pq_adc_gather_topk_plain(tables, codes, base, k, lut_dtype,
                                        scale)
    _check_cuda_codes(tables, codes)
    if base.dtype != torch.float32:
        raise TypeError(f"base must be float32, got {base.dtype}")
    if not base.is_contiguous():
        raise ValueError("base must be contiguous")
    c = codes.shape[1]
    dev = base.device
    mode = _LUT_MODE[lut_dtype]
    _check_smem(gather_topk_library().qpad_pq_adc_gather_topk_smem(
        mode, m, kc, k), m, kc, k)
    if nq == 0 or c == 0:
        return _empty(nq, k, dev)
    qt, s = _quantized(tables, lut_dtype, scale)
    plan = pq_adc_select_plan("gathered", nq, c, 1, m, kc, k, lut_dtype,
                              codes.element_size(), dev)
    out_d, out_i, sk, ss = _outputs(nq, k, plan["scratch"], dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = gather_topk_library().qpad_pq_adc_gather_topk(
            qt.data_ptr(), mode, s.data_ptr(), codes.data_ptr(),
            codes.element_size(), base.data_ptr(), nq, c, m, kc, k,
            plan["parts"], plan["units_per_part"], sk.data_ptr(),
            ss.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pq_adc_gather_topk launch failed: CUDA error "
                           f"{err}")
    pq_adc_gather_topk.launches += 1
    return out_d, out_i.long()


pq_adc_gather_topk.launches = 0


def _outputs(nq, k, n_scratch, dev):
    """(out_d, out_i) and the two merge scratch arrays of a K1 call."""
    return (torch.empty((nq, k), dtype=torch.float32, device=dev),
            torch.empty((nq, k), dtype=torch.int32, device=dev),
            torch.empty(n_scratch, dtype=torch.float32, device=dev),
            torch.empty(n_scratch, dtype=torch.int32, device=dev))


_select_plans = {}


def pq_adc_select_plan(source: str, nq: int, n_units: int, unit_rows: int,
                       m: int, kc: int, k: int, lut_dtype: str,
                       code_bytes: int, device) -> dict:
    """K1's launch plan (cached per shape and device): ``source``
    "gathered" splits each query's ``n_units`` slots (``unit_rows`` 1),
    "cells" its ``n_units`` probed cells of ``unit_rows`` (max_cell) rows,
    over ``parts`` blocks of ``units_per_part`` units, planned from the
    ``blocks_per_sm`` the kernel's occupancy allows on the ``sms`` SMs;
    ``blocks`` launched, the ``waves`` they make, the ``smem`` a block and
    the ``scratch`` length of each merge array."""
    dev = torch.device(device)
    key = (source, nq, n_units, unit_rows, m, kc, k, lut_dtype, code_bytes,
           dev)
    plan = _select_plans.get(key)
    if plan is None:
        lib = gather_topk_library()
        out = (ctypes.c_longlong * 5)()
        with torch.cuda.device(dev):
            err = lib.qpad_pq_adc_select_plan(
                _LUT_MODE[lut_dtype], code_bytes,
                {"gathered": 0, "cells": 1}[source], nq, n_units, unit_rows,
                m, kc, k, out)
        if err != 0:
            raise RuntimeError(f"pq_adc_select_plan failed: CUDA error {err}")
        parts, per, per_sm, sms, scratch = (int(v) for v in out)
        plan = {"parts": parts, "units_per_part": per,
                "blocks_per_sm": per_sm, "sms": sms, "blocks": nq * parts,
                "waves": nq * parts / (per_sm * sms), "scratch": scratch,
                "smem": int(lib.qpad_pq_adc_gather_topk_smem(
                    _LUT_MODE[lut_dtype], m, kc, k))}
        _select_plans[key] = plan
    return plan


def pq_adc_cells_topk_plain(tables, probe, cd2p, codes_cell, bias_cell, cand,
                            k, lut_dtype="f32", scale=None, live=None,
                            cell_len=None):
    """The cell-major entry's plain version: the padded scan's gather
    (``ref.gather_cells``, its empty slots from ``cand``, or from
    ``cell_len`` when ``cand`` is None), the slots where the cell-major map
    ``live`` is 0 masked (``ref.live_slots``), then
    ``pq_adc_gather_topk_plain``. A probed id outside [0, nlist) is an
    empty cell, as the kernel reads it. Runs on any device; the wrapper
    takes it for CPU tensors."""
    ccodes, base = gather_cells(probe, cand, cd2p, codes_cell, bias_cell,
                                cell_len)
    if live is not None:
        base = torch.where(live_slots(probe, live, base.shape[1]), base,
                           float("inf"))
    return pq_adc_gather_topk_plain(tables, ccodes, base, k, lut_dtype,
                                    scale)


def pq_adc_cells_topk(tables: torch.Tensor, probe: torch.Tensor,
                      cd2p: torch.Tensor, codes_cell: torch.Tensor,
                      bias_cell: torch.Tensor,
                      cand: Optional[torch.Tensor], k: int,
                      lut_dtype: str = "f32", scale=None, cell_len=None,
                      live=None):
    """K1 over an IVF-PQ index's probed cells, read where they lie.

    tables (Q, M, K) f32 as in ``pq_adc_gather_topk``; probe (Q, P) cell
    ids; cd2p (Q, P) f32 coarse distances; codes_cell (nlist, max_cell, M)
    uint8 (int32 for K > 256); bias_cell (nlist, max_cell) f32; cand (Q, C)
    candidate ids, -1 for an empty posting slot (its width C is the slot
    range; slot c = p * max_cell + r); a probed id outside [0, nlist)
    reads nothing and scores no slot (the shard-local scan passes -1 for
    a cell another rank owns). ``cell_len`` (nlist,), the fill
    ``(lists >= 0).sum(1)`` of each cell, may replace reading ``cand``
    only where the posting lists are left-packed (ids, then pads), as
    ``posting_lists`` builds them; beside it ``cand`` may be None, and
    the slot range is then P * max_cell (the caller maps the k selected
    slots to ids itself). ``live`` (nlist, max_cell) uint8 or bool, a
    cell-major map read beside ``cell_len`` (which it needs) in place like
    ``bias_cell``, masks a posting slot where it is 0, as ``cand`` -1
    would (a streaming store's tombstoned rows). Returns what
    ``pq_adc_gather_topk(tables, *gather_cells(probe, cand', cd2p,
    codes_cell, bias_cell, cell_len), k, ...)`` returns, bit for bit,
    cand' being ``cand`` with the dead slots -1 (``ref.live_slots``): (d2
    (Q, k) f32, slot (Q, k) int64).
    """
    extra = tuple(t for t in (cand, cell_len, live) if t is not None)
    _check_common(tables, k, lut_dtype, scale, probe, cd2p, codes_cell,
                  bias_cell, *extra)
    if cand is None and cell_len is None:
        raise ValueError("cand=None is read through cell_len; without the "
                         "fills, pass the candidate ids")
    if live is not None:
        if cell_len is None:
            raise ValueError("live= is read beside cell_len; without the "
                             "fills, mask cand instead")
        if tuple(live.shape) != tuple(bias_cell.shape):
            raise ValueError(f"live must be {tuple(bias_cell.shape)} "
                             f"(bias_cell's shape), got {tuple(live.shape)}")
    if tables.ndim != 3 or probe.ndim != 2 or codes_cell.ndim != 3 or \
            bias_cell.ndim != 2 or (cand is not None and cand.ndim != 2):
        raise ValueError("expected tables (Q, M, K), probe (Q, P), codes_cell "
                         "(nlist, max_cell, M), bias_cell (nlist, max_cell), "
                         "cand (Q, C)")
    nq, m, kc = tables.shape
    nlist, max_cell, _ = codes_cell.shape
    if probe.shape[0] != nq or tuple(cd2p.shape) != tuple(probe.shape) or \
            codes_cell.shape[2] != m or \
            tuple(bias_cell.shape) != (nlist, max_cell) or \
            (cand is not None and cand.shape[0] != nq):
        raise ValueError(f"shape mismatch: tables {tuple(tables.shape)}, "
                         f"probe {tuple(probe.shape)}, cd2p "
                         f"{tuple(cd2p.shape)}, codes_cell "
                         f"{tuple(codes_cell.shape)}, bias_cell "
                         f"{tuple(bias_cell.shape)}, cand "
                         f"{None if cand is None else tuple(cand.shape)}")
    if tables.device.type == "cpu":
        return pq_adc_cells_topk_plain(tables, probe, cd2p, codes_cell,
                                       bias_cell, cand, k, lut_dtype, scale,
                                       live, cell_len)
    _check_cuda_codes(tables, codes_cell)
    for name, t in (("cd2p", cd2p), ("bias_cell", bias_cell)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("probe", probe), ("cand", cand), ("cell_len", cell_len)):
        if t is not None and t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    # the kernel reads int64 ids (what torch's top-k and the port's
    # posting lists hold; an index bridged from JAX holds int32)
    if cell_len is not None:
        if tuple(cell_len.shape) != (nlist,):
            raise ValueError(f"cell_len must be ({nlist},), got "
                             f"{tuple(cell_len.shape)}")
        cell_len = cell_len.to(torch.int64).contiguous()
        if live is not None:
            live = live.to(torch.uint8).contiguous()
    else:
        cand = cand.to(torch.int64).contiguous()
    probe = probe.to(torch.int64).contiguous()
    cd2p, bias_cell = cd2p.contiguous(), bias_cell.contiguous()
    n_probe = probe.shape[1]
    c = n_probe * max_cell if cand is None else cand.shape[1]
    dev = codes_cell.device
    mode = _LUT_MODE[lut_dtype]
    _check_smem(gather_topk_library().qpad_pq_adc_gather_topk_smem(
        mode, m, kc, k), m, kc, k)
    if nq == 0 or c == 0 or n_probe == 0 or max_cell == 0:
        return _empty(nq, k, dev)
    qt, s = _quantized(tables, lut_dtype, scale)
    plan = pq_adc_select_plan("cells", nq, n_probe, max_cell, m, kc, k,
                              lut_dtype, codes_cell.element_size(), dev)
    out_d, out_i, sk, ss = _outputs(nq, k, plan["scratch"], dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = gather_topk_library().qpad_pq_adc_cells_topk(
            qt.data_ptr(), mode, s.data_ptr(), codes_cell.data_ptr(),
            codes_cell.element_size(), bias_cell.data_ptr(),
            probe.data_ptr(), cd2p.data_ptr(),
            None if cell_len is None else cell_len.data_ptr(),
            None if cell_len is not None else cand.data_ptr(),
            None if live is None else live.data_ptr(), nq, n_probe, nlist,
            max_cell, c, m, kc, k, plan["parts"], plan["units_per_part"],
            sk.data_ptr(), ss.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pq_adc_cells_topk launch failed: CUDA error "
                           f"{err}")
    pq_adc_cells_topk.launches += 1
    return out_d, out_i.long()


pq_adc_cells_topk.launches = 0


def pq_adc_topk(tables: torch.Tensor, codes: torch.Tensor, k: int,
                lut_dtype: str = "f32", scale=None):
    """ADC scan over one shared code matrix plus top-k (K2).

    tables (Q, M, K) f32, quantized here per ``lut_dtype`` as in
    ``pq_adc_gather_topk``; codes (N, M) uint8 (int32 for K > 256),
    scanned by every query.
    Returns (d2 (Q, k) f32 ascending, row (Q, k) int64). Each launch adds
    one to ``launches`` and to ``launches_by_qb[QB]``, QB being the queries
    a block served (``shared_layout``).
    """
    _check_common(tables, k, lut_dtype, scale, codes)
    if tables.ndim != 3 or codes.ndim != 2:
        raise ValueError("expected tables (Q, M, K) and codes (N, M)")
    nq, m, kc = tables.shape
    if codes.shape[1] != m:
        raise ValueError(f"shape mismatch: tables {tuple(tables.shape)}, "
                         f"codes {tuple(codes.shape)}")
    if tables.device.type == "cpu":
        return pq_adc_topk_plain(tables, codes, k, lut_dtype, scale)
    _check_cuda_codes(tables, codes)
    n = codes.shape[0]
    dev = codes.device
    qb, entry = shared_layout(nq, m, kc, k, lut_dtype, n)
    _check_smem(shared_smem_bytes(entry, qb, m, kc, k), m, kc, k)
    if nq == 0 or n == 0:
        return _empty(nq, k, dev)
    qt, s = _quantized(tables, lut_dtype, scale)
    packed = pack_shared_tables(qt, lut_dtype, qb)
    g = packed.shape[0]
    group = packed.reshape(g, -1).view(torch.uint8)
    gbytes = _table_bytes(entry, qb, m, kc)
    if group.shape[1] != gbytes:
        group = torch.nn.functional.pad(group, (0, gbytes - group.shape[1]))
    plan = pq_adc_topk_plan(codes, nq, kc, k, lut_dtype)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    sk = torch.empty(plan["scratch"], dtype=torch.float32, device=dev)
    ss = torch.empty(plan["scratch"], dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = topk_library().qpad_pq_adc_topk(
            group.data_ptr(), ENTRY_MODES[entry], qb, gbytes, s.data_ptr(),
            codes.data_ptr(), codes.element_size(), nq, n, m, kc, k,
            plan["work"], plan["parts"], plan["rows_per_part"],
            sk.data_ptr(), ss.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"pq_adc_topk launch failed: CUDA error {err}")
    pq_adc_topk.launches += 1
    _launches_by_qb[qb] = _launches_by_qb.get(qb, 0) + 1
    return out_d, out_i.long()


_plans = {}


def pq_adc_topk_plan(codes: torch.Tensor, nq: int, kc: int, k: int,
                     lut_dtype: str) -> dict:
    """K2's launch plan for ``nq`` queries over the CUDA ``codes`` (N, M)
    (cached per shape and device): the layout (``qb``, ``entry``,
    ``smem`` bytes a block), the row ``parts`` of its second grid axis and
    ``rows_per_part``, the ``blocks_per_sm`` its occupancy allows on the
    ``sms`` SMs, the ``blocks`` launched, the ``waves`` they make, and the
    ``scratch`` length of each merge array."""
    n, m = codes.shape
    code_bytes = codes.element_size()
    dev = codes.device
    qb, entry = shared_layout(nq, m, kc, k, lut_dtype, n)
    key = (nq, n, m, kc, k, lut_dtype, code_bytes, dev, qb)
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 5)()
        with torch.cuda.device(dev):
            err = topk_library().qpad_pq_adc_topk_plan(
                ENTRY_MODES[entry], qb, code_bytes, nq, n, m, kc, k,
                list_work(k, qb), out)
        if err != 0:
            raise RuntimeError(f"pq_adc_topk_plan failed: CUDA error {err}")
        parts, rows, per_sm, sms, scratch = (int(v) for v in out)
        blocks = -(-nq // qb) * parts
        plan = {"qb": qb, "entry": entry, "work": list_work(k, qb),
                "smem": shared_smem_bytes(entry, qb, m, kc, k),
                "parts": parts, "rows_per_part": rows,
                "blocks_per_sm": per_sm, "sms": sms, "blocks": blocks,
                "waves": blocks / (per_sm * sms), "scratch": scratch}
        _plans[key] = plan
    return plan


pq_adc_topk.launches = 0
# K2's launches by QB; the dict is the module's own, so a wrapper that
# stands in for ``pq_adc_topk`` (it then takes the ``launches`` count)
# leaves it counting
_launches_by_qb = {}
pq_adc_topk.launches_by_qb = _launches_by_qb


def _global_ids(topk, tables, codes, k, row_offset, n_valid, slack,
                lut_dtype, scale):
    """The shard-local steps of ``pq_adc_topk_global`` around ``topk`` (K2
    or its plain version): over-fetch k + slack rows, map them to global
    ids, drop the shard-pad rows (global id >= n_valid), re-take the top
    k; (+inf, -1) pads."""
    kk = min(k + slack, codes.shape[0])
    if kk < 1:
        return _empty(tables.shape[0], k, tables.device)
    d2, idx = topk(tables, codes, kk, lut_dtype, scale)
    gid = row_offset + idx
    bad = (idx < 0) | (gid >= n_valid)
    d2 = torch.where(bad, float("inf"), d2)
    gid = torch.where(bad, -1, gid)
    if kk > k:
        d2, sel = topk_smallest(d2, k)
        gid = torch.gather(gid, 1, sel)
    elif kk < k:
        d2 = torch.nn.functional.pad(d2, (0, k - kk), value=float("inf"))
        gid = torch.nn.functional.pad(gid, (0, k - kk), value=-1)
    return d2, gid


def pq_adc_topk_global_plain(tables, codes, k, row_offset, n_valid,
                             slack=0, lut_dtype="f32", scale=None):
    """``pq_adc_topk_global``'s plain version: ``pq_adc_topk_plain``
    through the same global-id steps. Runs on any device; the wrapper
    takes it for CPU tensors."""
    return _global_ids(pq_adc_topk_plain, tables, codes, k, row_offset,
                       n_valid, slack, lut_dtype, scale)


def pq_adc_topk_global(tables: torch.Tensor, codes: torch.Tensor, k: int, *,
                       row_offset: int, n_valid: int, slack: int = 0,
                       lut_dtype: str = "f32", scale=None):
    """K2 over one shard's (n_loc, M) row block, returning GLOBAL row ids
    (sharded serving; the counterpart of
    ``repro.kernels.pq_adc.ops.pq_adc_topk_global``).

    ``row_offset`` is the block's first global row. The kernel cannot see
    which rows are shard padding, so it over-fetches ``k + slack`` rows
    (``slack`` at least the pad rows a block may hold: shards - 1), the
    hits with a global id >= ``n_valid`` are dropped, and the top k is
    re-taken (ties to the lower row): a pad row never displaces a real
    one. Returns (d2 (Q, k) f32, global ids (Q, k) int64) with (+inf, -1)
    in unfilled slots; d2 is the merge key, not square-rooted. CPU
    tensors take the plain version; on CUDA each call launches K2 once
    (``pq_adc_topk.launches``) and adds one to ``launches``.
    """
    _check_common(tables, k, lut_dtype, scale, codes)
    if tables.device.type == "cpu":
        return pq_adc_topk_global_plain(tables, codes, k, row_offset,
                                        n_valid, slack, lut_dtype, scale)
    before = pq_adc_topk.launches
    out = _global_ids(pq_adc_topk, tables, codes, k, row_offset, n_valid,
                      slack, lut_dtype, scale)
    pq_adc_topk_global.launches += pq_adc_topk.launches - before
    return out


pq_adc_topk_global.launches = 0
