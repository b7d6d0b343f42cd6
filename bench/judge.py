"""What decides ``correct``: a sample of the window's answers, drawn from
the seed, held against the plain reference (``bench/reference``).

The numbers compared, each against the configuration's limit
(``checks``):

* ``recall_at_10``: the share of the reference's exact top-k that the
  answers hold (the configuration's stated recall; it catches a broken
  probe, scan, table or merge);
* ``dist_abs_err``: the widest gap between a returned distance and the
  float64 distance of the returned id's live row (the re-rank is exact in
  float32, so a stale row, an altered id or a lower precision shows);
* ``dead_ids``: returned ids that are not live at the query's step (a
  deleted id, an overwritten row's old copy is caught by the distance);
* ``writes_missed`` (a mix that writes): queries that are a row written in
  their own step whose answer lacks that row's id (read-your-writes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import STREAM_SAMPLE, sub_seed
from .reference import knn as ref
from .writes import Ledger


@dataclasses.dataclass
class Sample:
    units: np.ndarray               # (S,) the unit (step) of each answer
    queries: torch.Tensor           # (S, D) the query vectors
    got_d: Optional[torch.Tensor]   # (S, k) returned distances
    got_ids: Optional[torch.Tensor]  # (S, k) returned ids
    target: np.ndarray              # (S,) the id a write query wrote, or -1
    search_host_s: List[float]


def draw_sample(rec, work, seed: int, traffic: dict, keeper=None) -> Sample:
    """The answers the comparison reads, among the units whose answers
    were kept (``rec.kept``): in a read-only mix, distinct queries of the
    pool, each at one of its kept batches; in a mix that writes, ``steps``
    kept steps, each with its write queries and random others up to
    ``per_step``."""
    rng = np.random.default_rng(sub_seed(seed, STREAM_SAMPLE))
    kept = np.array(sorted(rec.kept), dtype=np.int64)
    pool = work.pool
    p_n, b = pool.shape[0], pool.shape[1]
    smp = traffic["sample"]
    if work.plan is None:
        seen = np.unique(kept % p_n)
        flat = rng.choice(seen.shape[0] * b,
                          min(int(smp["queries"]), seen.shape[0] * b),
                          replace=False)
        p, rows = seen[flat // b], flat % b
        units = np.array([rng.choice(kept[kept % p_n == x]) for x in p],
                         dtype=np.int64)
        queries = pool[torch.as_tensor(p), torch.as_tensor(rows)]
        target = np.full(units.shape[0], -1, dtype=np.int64)
    else:
        wq = work.write_queries
        steps = np.sort(rng.choice(kept, min(int(smp["steps"]),
                                             kept.shape[0]), replace=False))
        units, rows, qs, target = [], [], [], []
        wsel = work.wsel.cpu().numpy()
        for u in steps:
            r = np.concatenate([b - wq + np.arange(wq), rng.choice(
                b - wq, int(smp["per_step"]) - wq, replace=False)])
            up, _ = work.plan.steps[u]
            vec = work.gen.writes(up.shape[0], seed, int(u))
            qs.append(work.queries(int(u), vec)[torch.as_tensor(r)])
            t = np.full(r.shape[0], -1, dtype=np.int64)
            t[:wq] = up[wsel]
            units.append(np.full(r.shape[0], u))
            rows.append(r)
            target.append(t)
        units, rows = np.concatenate(units), np.concatenate(rows)
        queries, target = torch.cat(qs), np.concatenate(target)
    got_d = got_ids = None
    if keeper is not None:
        slot = torch.as_tensor([rec.kept[int(u)] for u in units])
        r = torch.as_tensor(rows)
        got_d = keeper.d[slot, r].clone()
        got_ids = keeper.ids[slot, r].clone()
    return Sample(units=units, queries=queries, got_d=got_d, got_ids=got_ids,
                  target=target, search_host_s=list(rec.search_host_s))


def compare(sample: Sample, gen, seed: int, corpus: torch.Tensor,
            steps: Optional[list], upserts: int, k: int,
            control: bool = False) -> Dict[str, float]:
    """The numbers compared. ``steps`` (a mix that writes) is the write
    schedule; the reference draws the written vectors again. With
    ``control`` the answers are the reference's own at TF32."""
    dev = corpus.device
    n = corpus.shape[0]
    parts = [corpus]
    last = int(sample.units.max()) if steps is not None else -1
    ledger = Ledger(n, steps or [], upserts, last)
    live = {}
    if steps is not None:
        parts.append(torch.cat([gen.writes(upserts, seed, s)
                                for s in range(last + 1)]))
        live = dict(step=torch.as_tensor(sample.units, device=dev),
                    start=torch.from_numpy(ledger.start).to(dev),
                    end=torch.from_numpy(ledger.end).to(dev))
    q = sample.queries.to(dev)
    _, ref_rows = ref.knn(q, parts, k, **live)
    row_id = torch.from_numpy(ledger.row_id).to(dev)
    ref_ids = torch.where(ref_rows >= 0, row_id[ref_rows.clamp_min(0)], -1)
    if control:
        c_d2, c_rows = ref.knn(q, parts, k, tf32=True, **live)
        got_d = c_d2.clamp_min(0.0).sqrt()
        got_ids = torch.where(c_rows >= 0, row_id[c_rows.clamp_min(0)], -1)
    else:
        got_d, got_ids = sample.got_d.to(dev), sample.got_ids.to(dev)
    got = got_ids.cpu().numpy()
    rows = ledger.rows_at(sample.units, got)
    true = ref.true_dist(q, ref.gather_rows(parts,
                                            torch.from_numpy(rows).to(dev)))
    has = torch.from_numpy(rows >= 0).to(dev)
    err = (got_d.double() - true).abs()
    dist_err = float(err[has].max()) if bool(has.any()) else float("inf")
    want = ref_ids.cpu().numpy()
    hits = ((want[:, :, None] == got[:, None, :]).any(axis=2) & (want >= 0))
    numbers = {"recall_at_10": float(hits.sum()) / float(want.size),
               "dist_abs_err": dist_err,
               "dead_ids": int(((got >= 0) & (rows < 0)).sum())}
    wq = sample.target >= 0
    if wq.any():
        found = (got[wq] == sample.target[wq][:, None]).any(axis=1)
        numbers["writes_missed"] = int((~found).sum())
    return numbers


def checks(numbers: Dict[str, float], limits: Dict[str, dict]) -> dict:
    """Each number beside its limit (``{"min": x}`` or ``{"max": x}``)."""
    out = {}
    for name, lim in limits.items():
        if name not in numbers:
            continue
        v = numbers[name]
        if "min" in lim:
            out[name] = {"value": v, "limit": lim["min"], "rule": ">=",
                         "ok": bool(v >= lim["min"])}
        else:
            out[name] = {"value": v, "limit": lim["max"], "rule": "<=",
                         "ok": bool(v <= lim["max"])}
    return out
