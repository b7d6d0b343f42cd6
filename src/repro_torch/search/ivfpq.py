"""IVF-PQ: coarse k-means quantizer + product-quantized residuals (port of
``repro.search.ivfpq``).

Scoring uses the exact residual decomposition, so the per-query lookup
table is cell-independent; with reconstruction x^ = c + r^:

  ||q - x^||^2 = ||q - c||^2                          (coarse term)
               + sum_m (||cb[m,code_m]||^2 - 2<q_m, cb[m,code_m]>)  (table)
               + 2 sum_m <c_m, cb[m,code_m]>          (per-id ``bias``)

``backend="kernel"`` scores the candidates with kernel K1, ``backend="jnp"``
with the plain scorer over gathered candidates; the name keeps the spec
grammar's ``@jnp`` token, so one spec string drives both packages. With
the kernel the padded scan takes K1's cell-major entry
(``ops.pq_adc_cells_topk``), which on a CUDA device reads the probed
cells of ``codes_cell`` / ``bias_cell`` where they lie (on the CPU its
plain version gathers them first); the compact scan gathers its
candidates and takes the gathered entry (``ops.pq_adc_gather_topk``).

``lists`` rows are left-packed (a cell's ids ascending, then -1 pads), as
``posting_lists`` builds them and the JAX package's do: the padded scan
hands K1 each cell's fill, ``(lists >= 0).sum(1)``, in place of reading
the candidate ids, and builds no candidate-id table (``lists[probe]``,
Q x nprobe * max_cell ids): K1 returns the k best slots, and only those
are mapped to ids, slot p * max_cell + r of query q being
``lists[probe[q, p], r]``. The plain route (``@jnp``) and the compact
scan gather their candidates, so they build the table they read.

A streaming scan passes ``live`` (the store's (n_cap,) bool map of rows
allocated and not tombstoned): a dead row scores as a posting pad, +inf
in the additive base. The scan turns it into a cell-major byte map of the
posting slots (``live_cells``, the shape of ``bias_cell``, made once a
search whatever the batch). K1's cell-major entry reads it in place
beside the cells' fills (a compacted store's lists stay left-packed, dead
rows included); the other routes set a dead candidate's id to -1, where
the JAX package masks ``base``: the same slots, the same scores.

``ivfpq_local_scan`` is the shard-local scan of sharded serving: the
probe and the tables run on replicated inputs, and only the probed cells
the rank owns are scored, through the same cell-major entry (and the same
slot-to-id mapping) with the probed ids of cells owned elsewhere set to
-1 (K1 reads nothing for a probed id outside [0, nlist), and its plain
version treats it as an empty cell). ``build_ivfpq(..., shards=,
balance=)`` lays the cell axis out for it (see ``ivf.posting_lists`` and
``ivf.balance_cells``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_adc.ref import (gather_cells, live_slots,
                                            pq_adc_gather_scores_ref)

from .ivf import (_balanced_layout, kmeans, nearest, posting_lists,
                  probe_cells, sq_dists)
from .knn import topk_smallest
from .pq import _check_adc_args, adc_tables, build_pq
from .tracing import span

__all__ = ["IVFPQIndex", "build_ivfpq", "ivfpq_lut_stats", "live_cells",
           "ivfpq_probe", "ivfpq_adc_scan", "ivfpq_scan_given_probe",
           "ivfpq_scan_inputs", "ivfpq_compact_scan", "ivfpq_local_scan",
           "ivfpq_scan", "ivfpq_search"]


class IVFPQIndex(NamedTuple):
    centroids: torch.Tensor    # (nlist, d) coarse quantizer
    lists: torch.Tensor        # (nlist, max_cell) int64 ids, then -1 pads
    codebooks: torch.Tensor    # (M, K, dsub) residual PQ codebooks
    codes: torch.Tensor        # (N, M) uint8 residual codes, id-aligned
    bias: torch.Tensor         # (N,) f32: 2 sum_m <cent[assign]_m, cb[m, code_m]>
    rerr: torch.Tensor         # (N,) f32 PQ reconstruction error ||x - x^||
    codes_cell: torch.Tensor   # (nlist, max_cell, M) cell-major codes
    bias_cell: torch.Tensor    # (nlist, max_cell) f32, 0 on pads
    lut_w: torch.Tensor        # (d, M*K) block-diagonal -2*codebook projection
    cbnorm: torch.Tensor       # (M, K) residual codeword squared norms


def build_ivfpq(vectors: torch.Tensor, nlist: int, m_subspaces: int = 8,
                n_centroids: int = 256, kmeans_iters: int = 12,
                pq_iters: int = 10, *, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                coarse_init: Optional[torch.Tensor] = None,
                pq_inits: Optional[torch.Tensor] = None,
                shards: int = 1, balance: bool = True) -> IVFPQIndex:
    """Coarse k-means, then per-subspace codebooks on the residuals.

    ``coarse_init`` / ``pq_inits`` are the k-means starting rows (see
    ``kmeans`` and ``build_pq``); without them they are drawn from
    ``generator``, coarse first. ``shards`` pads the cell axis of the
    cell-major mirrors (``lists`` / ``codes_cell`` / ``bias_cell``) to a
    multiple of the shard count; ``balance`` (with ``shards > 1``) also
    permutes it so the shard blocks carry near-equal posting mass. The
    quantization and the scan results are the same either way.
    """
    dev = resolve_device(device)
    vectors = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
    n, d = vectors.shape
    cent = kmeans(vectors, nlist, kmeans_iters, init=coarse_init,
                  generator=generator)
    assign = nearest(vectors, cent)                       # (N,)
    if balance and shards > 1:
        cent, assign = _balanced_layout(cent, assign, nlist, shards)
    lists = posting_lists(assign, nlist, shards)
    residuals = vectors - cent[assign]
    pq = build_pq(residuals, m_subspaces, n_centroids, pq_iters,
                  inits=pq_inits, generator=generator)
    dsub = d // m_subspaces
    csub = cent[assign].reshape(n, m_subspaces, dsub)     # (N, M, dsub)
    ar = torch.arange(m_subspaces, device=dev)
    recon = pq.codebooks[ar[None, :], pq.codes.long()]    # (N, M, dsub)
    bias = 2.0 * (csub * recon).sum(dim=(1, 2))
    rerr = ((residuals - recon.reshape(n, d)) ** 2).sum(dim=1).sqrt()
    lid = lists.clamp_min(0)
    return IVFPQIndex(centroids=cent, lists=lists, codebooks=pq.codebooks,
                      codes=pq.codes, bias=bias, rerr=rerr,
                      codes_cell=pq.codes[lid],
                      bias_cell=torch.where(lists >= 0, bias[lid], 0.0),
                      lut_w=pq.lut_w, cbnorm=pq.cbnorm)


def ivfpq_lut_stats(codebooks: torch.Tensor, cbnorm: torch.Tensor,
                    q: torch.Tensor, lut_dtype: str):
    """Analytic row-mean centering + certified int8 scale of the tables.

    rowmean[q, m] = mean_k cbnorm[m, :] - 2 <q_m, mean_k cb[m, :]>, and by
    Cauchy-Schwarz on the centered codewords every centered entry is at
    most max_k|cbnorm_c[m]| + ||q_m|| max_k||-2 cb_c[m, k]||, with 1e-5
    headroom for the rounding of the tables. Returns (rowmean (Q, M),
    scale (Q,) or None when ``lut_dtype`` needs no scale).
    """
    nq = q.shape[0]
    m, kc = cbnorm.shape
    dsub = codebooks.shape[2]
    qs = q.reshape(nq, m, dsub)
    wmean = -2.0 * codebooks.mean(dim=1)                  # (M, dsub)
    cbmean = cbnorm.mean(dim=1)                           # (M,)
    rowmean = cbmean[None] + torch.einsum("qmd,md->qm", qs, wmean)
    if lut_dtype != "int8":
        return rowmean, None
    w_c = -2.0 * codebooks - wmean[:, None, :]            # centered codewords
    wmax = (w_c * w_c).sum(dim=2).sqrt().amax(dim=1)      # (M,)
    cbmax = (cbnorm - cbmean[:, None]).abs().amax(dim=1)  # (M,)
    qn = (qs * qs).sum(dim=2).sqrt()                      # (Q, M)
    bound = (cbmax[None] + qn * wmax[None]).amax(dim=1) * (1.0 + 1e-5)
    return rowmean, bound.clamp_min(1e-12) / 127.0


def _score_topk(tables, q, codebooks, cbnorm, n_cand, k, lut_dtype, select,
                slot_ids):
    """Shared tail of the padded and compact scans: (int8) centering, the
    ADC top-k ``select(tables, center, scale, k)`` -> (d2, slot), restore
    the centre, map the selected slots to ids (``slot_ids``), pad up to
    ``n_cand``."""
    center = scale = None
    if lut_dtype == "int8":
        # the int8 grid only covers the candidate-varying part of the
        # table; the per-query constant sum_m center returns after top-k
        center, scale = ivfpq_lut_stats(codebooks, cbnorm, q, lut_dtype)
    d2, sel = select(tables, center, scale, k)
    if center is not None:
        d2 = d2 + center.sum(dim=1)[:, None]              # inf pads stay inf
    ids = torch.where(torch.isinf(d2), -1, slot_ids(sel))
    if k < n_cand:
        pad = n_cand - k
        d2 = torch.nn.functional.pad(d2, (0, pad), value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return d2, ids


def _cand_ids(cand):
    """Slot -> id through a candidate-id table ``cand`` (Q, C); -1 for an
    unfilled slot (sel < 0)."""
    def slot_ids(sel):
        return torch.where(sel >= 0, torch.gather(cand, 1, sel.clamp_min(0)),
                           -1)
    return slot_ids


def _cell_ids(lists, probe):
    """Slot -> id without a candidate-id table: slot s = p * max_cell + r
    of query q is ``lists[probe[q, p], r]``, looked up for the selected
    slots only. An unfilled slot (sel < 0) and a slot of a probed id
    outside [0, nlist), which K1 never scores, come with a +inf distance,
    which ``_score_topk`` maps to -1: here they are only kept in bounds."""
    nlist, max_cell = lists.shape

    def slot_ids(sel):
        s = sel.clamp_min(0)
        p = torch.div(s, max_cell, rounding_mode="floor")
        cell = torch.gather(probe, 1, p).clamp(0, nlist - 1)
        return lists[cell, s - p * max_cell]
    return slot_ids


def _gathered_select(ccodes, base, backend, lut_dtype):
    """Top-k over gathered candidates: K1's gathered entry, or the plain
    scorer."""
    def select(tables, center, scale, k):
        if backend == "kernel":
            kt = tables if center is None else tables - center[:, :, None]
            return adc_ops.pq_adc_gather_topk(kt, ccodes, base, k,
                                              lut_dtype=lut_dtype,
                                              scale=scale)
        adc = pq_adc_gather_scores_ref(tables, ccodes, base, lut_dtype,
                                       scale, center)
        return topk_smallest(adc, k)
    return select


def ivfpq_scan_inputs(probe, cand, cd2p, codes_cell, bias_cell):
    """Candidate codes (Q, C, M) and additive base (Q, C) of a padded scan:
    nprobe contiguous cell-major row blocks per query; posting pads get
    base +inf (``kernels.pq_adc.ref.gather_cells``)."""
    return gather_cells(probe, cand, cd2p, codes_cell, bias_cell)


def live_cells(lists: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(nlist, max_cell) uint8 map of the posting slots: 1 where ``lists``
    holds a row that ``live`` (N,) marks true, 0 on dead rows and pads."""
    ok = live[lists.clamp(0, live.shape[0] - 1)]
    return ((lists >= 0) & ok).to(torch.uint8)


def ivfpq_scan_given_probe(probe, cand, cd2p, codes_cell, bias_cell, lut_w,
                           cbnorm, codebooks, q, n_cand: int,
                           backend: str = "jnp", lut_dtype: str = "f32",
                           cell_len=None, cell_live=None, lists=None):
    """ADC scan given an already-computed coarse probe. Returns (d2 (Q,
    n_cand) squared approximate distances, ids) with (+inf, -1) on masked
    or unfilled slots. With ``backend="kernel"``, K1's cell-major entry
    scores the probed cells in place (given ``cell_len``, the cells' fills,
    only for left-packed lists; else it reads ``cand``); with ``"jnp"``
    the candidates are gathered first. ``cand`` (Q, C), the candidate-id
    table ``probe_cells`` builds, may be None beside ``cell_len`` on the
    kernel backend: the k selected slots are then mapped to ids from
    ``lists`` (the posting lists ``probe`` indexes), the same ids.
    ``cell_live`` (nlist, max_cell) (``live_cells``) masks posting slots
    where it is 0: beside ``cell_len`` the kernel reads it in place, else
    the dead candidates' ids become -1."""
    q = q.to(torch.float32)
    kernel_map = backend == "kernel" and cell_len is not None
    if cand is None:
        if not kernel_map or lists is None:
            raise ValueError("cand=None needs backend='kernel' with cell_len, "
                             "and lists to map the selected slots to ids")
        slot_ids = _cell_ids(lists, probe)
        k = min(n_cand, probe.shape[1] * lists.shape[1])
    else:
        if cell_live is not None and not kernel_map:
            cand = torch.where(live_slots(probe, cell_live, cand.shape[1]),
                               cand, -1)
        slot_ids = _cand_ids(cand)
        k = min(n_cand, cand.shape[1])
    tables = adc_tables(lut_w, cbnorm, q)
    if backend == "kernel":
        def select(tables, center, scale, k):
            kt = tables if center is None else tables - center[:, :, None]
            return adc_ops.pq_adc_cells_topk(
                kt, probe, cd2p, codes_cell, bias_cell, cand, k,
                lut_dtype=lut_dtype, scale=scale, cell_len=cell_len,
                live=cell_live if kernel_map else None)
    else:
        ccodes, base = ivfpq_scan_inputs(probe, cand, cd2p, codes_cell,
                                         bias_cell)
        select = _gathered_select(ccodes, base, backend, lut_dtype)
    return _score_topk(tables, q, codebooks, cbnorm, n_cand, k, lut_dtype,
                       select, slot_ids)


def ivfpq_probe(centroids, lists, q, nprobe: int, n_cand: int,
                backend: str = "jnp"):
    """The padded scan's probe: (probe (Q, nprobe) cell ids, cand, coarse
    d2 (Q, nprobe), cell_len). With ``backend="kernel"`` K1 reads the
    probed cells in place beside their fills, ``cell_len`` =
    ``(lists >= 0).sum(1)``, and no candidate-id table is built (``cand``
    None); the plain route gathers its candidates by ``probe_cells``'s
    (Q, max(nprobe * max_cell, n_cand)) table (``cell_len`` None)."""
    if backend == "kernel":
        cd2p, probe = topk_smallest(sq_dists(q, centroids), nprobe)
        return probe, None, cd2p, (lists >= 0).sum(dim=1)
    probe, cand, cd2p = probe_cells(centroids, lists, q, nprobe, n_cand)
    return probe, cand, cd2p, None


def ivfpq_adc_scan(centroids, lists, codes_cell, bias_cell, lut_w, cbnorm,
                   codebooks, q, n_cand: int, nprobe: int = 8,
                   backend: str = "jnp", lut_dtype: str = "f32", live=None):
    """Probe + cell-major ADC scan over raw index arrays (the padded scan:
    ``nprobe * max_cell`` candidate slots per query). ``lists`` must be
    left-packed (see the module's docstring). ``live`` (N,) bool keyed by
    row id masks tombstoned and unallocated rows (the streaming scan)."""
    _check_adc_args(backend, lut_dtype)
    q = q.to(torch.float32)
    with span("search.probe"):
        probe, cand, cd2p, cell_len = ivfpq_probe(centroids, lists, q,
                                                  nprobe, n_cand, backend)
    cell_live = None
    if live is not None:
        with span("search.live_map"):
            cell_live = live_cells(lists, live)
    with span("search.scan"):
        return ivfpq_scan_given_probe(probe, cand, cd2p, codes_cell,
                                      bias_cell, lut_w, cbnorm, codebooks, q,
                                      n_cand, backend=backend,
                                      lut_dtype=lut_dtype, cell_len=cell_len,
                                      cell_live=cell_live, lists=lists)


def ivfpq_compact_scan(centroids, lists, codes_cell, bias_cell, lut_w,
                       cbnorm, codebooks, q, n_cand: int, nprobe: int = 8,
                       scan_cap: int = 128, backend: str = "jnp",
                       lut_dtype: str = "f32"):
    """nprobe-proportional ADC scan for small query buckets.

    Per-query prefix sums over the probed cell lengths map a flat slot
    ``j < scan_cap`` to (cell, in-cell slot), so the gather is sized by the
    real posting mass. Candidates come probe-major in in-cell order, the
    padded scan's order minus its pads, so the returned ids equal the
    padded scan's whenever ``scan_cap`` covers each query's probed mass.
    """
    _check_adc_args(backend, lut_dtype)
    if scan_cap <= 0:
        raise ValueError("ivfpq_compact_scan needs scan_cap > 0")
    q = q.to(torch.float32)
    with span("search.probe"):
        cd2 = sq_dists(q, centroids)                      # (Q, nlist)
        cd2p, probe = topk_smallest(cd2, nprobe)
    with span("search.scan"):
        tables = adc_tables(lut_w, cbnorm, q)
        lens = (lists >= 0).sum(dim=1)                    # (nlist,) mass
        plens = lens[probe]                               # (Q, P)
        cum = torch.cumsum(plens, dim=1)                  # inclusive
        start = cum - plens
        total = cum[:, -1:]
        j = torch.arange(scan_cap, device=q.device)
        # flat slot -> probe slot: the count of prefix sums <= j
        p = (cum[:, :, None] <= j[None, None, :]).sum(dim=1)   # (Q, S)
        pc = p.clamp(0, nprobe - 1)
        cell = torch.gather(probe, 1, pc)                 # (Q, S)
        r = j[None, :] - torch.gather(start, 1, pc)       # in-cell slot
        rc = r.clamp(0, lists.shape[1] - 1)
        ok = j[None, :] < total                           # real posting mass
        cand = torch.where(ok, lists[cell, rc], -1)
        ccodes = codes_cell[cell, rc]                     # (Q, S, M)
        base = torch.gather(cd2p, 1, pc) + bias_cell[cell, rc]
        base = torch.where(cand >= 0, base, float("inf"))
        return _score_topk(tables, q, codebooks, cbnorm, n_cand,
                           min(n_cand, scan_cap), lut_dtype,
                           _gathered_select(ccodes, base, backend, lut_dtype),
                           _cand_ids(cand))


def ivfpq_scan(index: IVFPQIndex, q: torch.Tensor, k: int, nprobe: int = 8,
               backend: str = "jnp", lut_dtype: str = "f32"):
    """Padded ADC scan of an ``IVFPQIndex``: (approx dists (Q, k), ids)."""
    d2, ids = ivfpq_adc_scan(index.centroids, index.lists, index.codes_cell,
                             index.bias_cell, index.lut_w, index.cbnorm,
                             index.codebooks, q, k, nprobe, backend,
                             lut_dtype)
    return d2.clamp_min(0.0).sqrt(), ids


def ivfpq_local_scan(centroids, lists_loc, codes_cell_loc, bias_cell_loc,
                     lut_w, cbnorm, codebooks, q, n_cand: int, nprobe: int,
                     shard: int, backend: str = "jnp", lut_dtype: str = "f32",
                     live=None):
    """Shard-local IVF-PQ probe + ADC scan (sharded serving).

    The coarse probe and the per-query tables run on replicated inputs
    (centroids, ``lut_w`` / ``cbnorm``), so they are the same on every
    rank; only the probed cells this rank owns (rows of the cell-major
    mirrors, the block starting at ``shard * nlist_local``) are scored: a
    probe of a cell owned elsewhere is passed as -1, which K1's cell-major
    entry (``backend="kernel"``) reads nothing for and its plain version
    scores as an empty cell. The slot numbering p * max_cell + r is the
    single-device scan's, so ties break the same way. ``live`` (n_cap,)
    bool (streaming) masks tombstoned and unallocated rows, as a
    cell-major map of the local block (``live_cells``). Returns (d2 (Q,
    n_cand) squared approximate distances, global ids (Q, n_cand)) with
    (+inf, -1) on masked or unfilled slots."""
    _check_adc_args(backend, lut_dtype)
    q = q.to(torch.float32)
    cd2p, probe = topk_smallest(sq_dists(q, centroids), nprobe)
    nl_loc = lists_loc.shape[0]
    lp = probe - shard * nl_loc
    own = (lp >= 0) & (lp < nl_loc)
    cand = cell_len = None
    if backend == "kernel":
        cell_len = (lists_loc >= 0).sum(dim=1)
    else:
        cand = torch.where(own[:, :, None],
                           lists_loc[lp.clamp(0, nl_loc - 1)],
                           -1).reshape(q.shape[0], -1)
    cell_live = None if live is None else live_cells(lists_loc, live)
    return ivfpq_scan_given_probe(torch.where(own, lp, -1), cand, cd2p,
                                  codes_cell_loc, bias_cell_loc, lut_w,
                                  cbnorm, codebooks, q, n_cand,
                                  backend=backend, lut_dtype=lut_dtype,
                                  cell_len=cell_len, cell_live=cell_live,
                                  lists=lists_loc)


def ivfpq_search(index: IVFPQIndex, q: torch.Tensor, k: int,
                 nprobe: int = 8, backend: str = "jnp",
                 lut_dtype: str = "f32"):
    """Probe ``nprobe`` cells, ADC-score their residual codes, top-k.

    Returns (approx dists (Q, k), ids (Q, k)). ``backend="kernel"`` scores
    the candidates with K1's cell-major entry; ``lut_dtype`` quantizes the
    per-query residual LUT on either backend. The JAX package jits
    ``ivfpq_scan`` under this name (its ``interpret`` flag selects the
    Pallas interpret mode and has no counterpart here)."""
    return ivfpq_scan(index, q, k, nprobe, backend, lut_dtype)
