"""Plain PyTorch versions of the ADC top-k kernels K1 and K2.

Port of ``repro.kernels.pq_adc.ref``: the semantic spec that the CUDA
kernels in ``csrc/`` are held against, and what the scans run on CPU
tensors and under the ``@jnp`` backend. Two variants mirror the two
kernels:

    shared codes (K2):   out[q, n] = sum_m tables[q, m, codes[n, m]]
    gathered codes (K1): out[q, c] = base[q, c] + sum_m tables[q, m, codes[q, c, m]]

K1's cell-major entry scores an IVF-PQ index's probed cells where they
lie; its plain version is ``gather_cells`` (the padded scan's gather,
its empty slots read from the candidate ids or from the cells' fills)
followed by the gathered top-k. A cell-major live map (a streaming
store's tombstones) masks slots through ``live_slots``. A probed cell id
outside [0, nlist) is an empty cell in both, as the kernel reads it.

The tables are snapped onto the ``lut_dtype`` grid but kept in f32 (see
``lut.py``), so the lookup is one flat gather over the (Q, M*K) table at
f32 regardless of the LUT precision, and int8 scores (exact integer sums
times one per-query scale) are bit-identical to the kernel's int32 path.

``scale`` (int8 only) overrides the per-query scale with a caller-certified
bound; ``center`` (Q, M) is subtracted from the tables before the snap and
the returned score omits ``sum_m center`` (the caller adds it back after
top-k). The selection is ``topk_smallest``: ascending, ties to the lower
slot, as ``lax.top_k`` orders them.
"""
from __future__ import annotations

import torch

from repro_torch.search.knn import topk_smallest

from .lut import _int8_scale, fma_f32, snap_values

__all__ = ["pq_adc_scores_ref", "pq_adc_topk_ref",
           "pq_adc_gather_scores_ref", "pq_adc_gather_topk_ref",
           "gather_cells", "live_slots"]


def _resolve_scale(tables, lut_dtype, scale, center):
    """Per-query int8 scale: caller-certified, or max|t - center| / 127."""
    if lut_dtype != "int8":
        return None
    if scale is not None:
        return torch.as_tensor(scale, dtype=torch.float32,
                               device=tables.device)
    ct = tables if center is None else tables - center[:, :, None]
    return _int8_scale(ct, None)


def _snap_tables(tables, lut_dtype, scale, center):
    """Center + grid-snap the (Q, M, K) tables. As in the JAX version a
    non-finite first entry (a non-finite query) keeps the tables unsnapped;
    the choice is made on the device, without a host sync."""
    if lut_dtype == "f32":
        return tables
    tc = tables if center is None else tables - center[:, :, None]
    snapped = snap_values(tc, lut_dtype,
                          None if scale is None else scale[:, None, None])
    return torch.where(torch.isfinite(tables[0, 0, 0]), snapped, tables)


def pq_adc_scores_ref(tables: torch.Tensor, codes: torch.Tensor,
                      lut_dtype: str = "f32", scale=None,
                      center=None) -> torch.Tensor:
    """ADC distances over one shared code matrix.

    tables (Q, M, K) f32; codes (N, M) uint8 or int. Returns (Q, N) f32
    (minus ``sum_m center`` when ``center`` is given). The M lookups are
    added from 0 in ascending m, the order of the JAX reference and of the
    kernel; int8 sums are exact and take the scale once.
    """
    tables = tables.to(torch.float32)
    nq, m, _ = tables.shape
    scale = _resolve_scale(tables, lut_dtype, scale, center)
    ft = _snap_tables(tables, lut_dtype, scale, center)
    idx = codes.to(torch.int64)
    d2 = torch.zeros((nq, codes.shape[0]), dtype=torch.float32,
                     device=tables.device)
    for j in range(m):                 # in place: (Q, N) can be gigabytes
        d2.add_(ft[:, j, :].index_select(1, idx[:, j]))
    if lut_dtype == "int8":
        d2.mul_(scale[:, None])        # exact integer sums, one rescale
    return d2


def pq_adc_topk_ref(tables: torch.Tensor, codes: torch.Tensor, k: int,
                    lut_dtype: str = "f32", scale=None, center=None):
    """Returns (d2 (Q, k) ascending, row (Q, k) int64) over the shared code
    matrix, in the order of ``lax.top_k`` (ties to the lower row)."""
    return topk_smallest(pq_adc_scores_ref(tables, codes, lut_dtype, scale,
                                           center), k)


def pq_adc_gather_scores_ref(tables: torch.Tensor, codes: torch.Tensor,
                             base: torch.Tensor, lut_dtype: str = "f32",
                             scale=None, center=None) -> torch.Tensor:
    """ADC distances over per-query candidate codes.

    tables (Q, M, K) f32; codes (Q, C, M) uint8 or int; base (Q, C) f32
    (+inf masks padded candidates; never quantized). Returns (Q, C) f32
    (minus ``sum_m center`` when ``center`` is given).
    """
    tables = tables.to(torch.float32)
    nq, m, kc = tables.shape
    scale = _resolve_scale(tables, lut_dtype, scale, center)
    ft = _snap_tables(tables, lut_dtype, scale, center)
    c = codes.shape[1]
    offs = torch.arange(m, device=codes.device, dtype=torch.int64) * kc
    flat_idx = (codes.to(torch.int64) + offs).reshape(nq, c * m)
    lut = torch.gather(ft.reshape(nq, m * kc), 1, flat_idx)
    d2 = lut.reshape(nq, c, m).sum(dim=-1)
    if lut_dtype == "int8":
        # exact integer sums, one rescale fused with the base add (as XLA
        # and the kernel compute it)
        return fma_f32(d2, scale[:, None], base)
    return base.to(torch.float32) + d2


def pq_adc_gather_topk_ref(tables: torch.Tensor, codes: torch.Tensor,
                           base: torch.Tensor, k: int, lut_dtype: str = "f32",
                           scale=None, center=None):
    """Returns (d2 (Q, k) ascending, slot (Q, k) int64), the order of
    ``lax.top_k``; masked slots keep their +inf score and their slot id."""
    d2 = pq_adc_gather_scores_ref(tables, codes, base, lut_dtype, scale,
                                  center)
    return topk_smallest(d2, k)


def _probed(probe: torch.Tensor, nlist: int):
    """(probed cell ids clamped into [0, nlist), in-range mask): a probed
    id outside [0, nlist) is no cell, as the kernel reads it (a negative
    id must not wrap to the last cell through Python's indexing)."""
    ok = (probe >= 0) & (probe < nlist)
    return probe.clamp(0, nlist - 1), ok


def gather_cells(probe: torch.Tensor, cand, cd2p: torch.Tensor,
                 codes_cell: torch.Tensor, bias_cell: torch.Tensor,
                 cell_len=None):
    """Candidate codes (Q, C, M) and additive base (Q, C) of an IVF-PQ
    padded scan: the nprobe probed cells' contiguous cell-major rows, slot
    p * max_cell + r from cell probe[q, p]; base cd2p[q, p] +
    bias_cell[cell, r] (one f32 add), +inf where ``cand`` < 0 (an empty
    posting slot, or a slot past P * max_cell) and on every slot of a
    probed id outside [0, nlist), which is an empty cell (the kernel's
    contract: such a probe reads nothing). ``cand`` may be None beside
    ``cell_len`` (nlist,), the fills of left-packed lists: C is then P *
    max_cell and slot r of a cell is empty iff r >= cell_len[cell], the
    mask ``cand`` < 0 gives on such lists."""
    nq = probe.shape[0]
    nlist, max_cell, m = codes_cell.shape
    cell, inside = _probed(probe, nlist)
    ccodes = codes_cell[cell].reshape(nq, -1, m)
    base = (cd2p.repeat_interleave(max_cell, dim=1)
            + bias_cell[cell].reshape(nq, -1))            # (Q, P*max_cell)
    base = torch.where(inside.repeat_interleave(max_cell, dim=1), base,
                       float("inf"))
    if cand is None:
        if cell_len is None:
            raise ValueError("gather_cells needs cand or cell_len")
        r = torch.arange(max_cell, device=probe.device)
        filled = r[None, None, :] < cell_len[cell][:, :, None]
        return ccodes, torch.where(filled.reshape(nq, -1), base,
                                   float("inf"))
    short = cand.shape[1] - base.shape[1]                 # degenerate budget
    if short:
        ccodes = torch.nn.functional.pad(ccodes, (0, 0, 0, short))
        base = torch.nn.functional.pad(base, (0, short))
    base = torch.where(cand >= 0, base, float("inf"))
    return ccodes, base


def live_slots(probe: torch.Tensor, live: torch.Tensor,
               n_slots: int) -> torch.Tensor:
    """(Q, n_slots) bool over a padded scan's slots from a cell-major byte
    map ``live`` (nlist, max_cell): slot p * max_cell + r of query q is
    ``live[probe[q, p], r] != 0``; slots past P * max_cell, and every slot
    of a probed id outside [0, nlist), are False."""
    nq = probe.shape[0]
    cell, inside = _probed(probe, live.shape[0])
    ok = ((live[cell] != 0) & inside[:, :, None]).reshape(nq, -1)[:, :n_slots]
    short = n_slots - ok.shape[1]
    if short:
        ok = torch.cat([ok, ok.new_zeros((nq, short))], dim=1)
    return ok
