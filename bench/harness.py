"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result line's contents.

The system under test is the PyTorch / CUDA port's search engine,
``repro_torch.search.serve``: ``build_engine`` in set-up (the QPAD fit on
kernel K4, the index build), then ``SearchEngine.search`` in the window,
and in a cell whose traffic writes, ``SearchEngine.upsert`` and
``delete`` before each search. The benchmark hands the program only the
rows, queries and writes it made; it reads back the answers, the engine's
``counters`` and the kernel wrappers' ``launches``.

A closed loop keeps ``in_flight`` batches queued on the card: before it
submits a batch it waits for the completion event of the batch that many
places back, and never synchronizes otherwise. A batch's latency runs from
the host's clock at its submission to the device's clock at its
completion event, both on one time line (an event recorded on an empty
queue at the window's start ties the two).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import data, judge, trace
from .catalog import Cell
from .writes import WritePlan

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of the JAX package and JAX itself among ``modules``
    (default: what this process has loaded), compared whole
    (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Clock:
    """Host time since the window's start, and device completion times on
    the same line. On the CPU (tests) the work is done when the call
    returns, so a mark is the host's clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.free: List = []       # events to record again

    def start(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def mark(self):
        if self.cuda:
            ev = (self.free.pop() if self.free
                  else torch.cuda.Event(enable_timing=True))
            ev.record()
            return ev
        return self.now()

    def release(self, mark):
        """A completed mark whose time has been read is recorded again
        (no event is made a batch)."""
        if self.cuda:
            self.free.append(mark)

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def at(self, mark) -> float:
        """Seconds from the window's start to the mark's completion."""
        if self.cuda:
            return self.e0.elapsed_time(mark) / 1e3
        return mark


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@dataclasses.dataclass
class Units:
    """What the units of work of a window recorded."""
    first: int
    submit: List[float] = dataclasses.field(default_factory=list)
    done: List[float] = dataclasses.field(default_factory=list)
    search_host_s: List[float] = dataclasses.field(default_factory=list)
    write_s: List[float] = dataclasses.field(default_factory=list)
    kept: Dict[int, int] = dataclasses.field(default_factory=dict)


class Keeper:
    """Copies of the answers of the units the seed marks (one in
    ``every``) into buffers made in set-up, for the comparison after the
    window. Holding every batch's own output tensors instead makes the
    card's allocator take a new 2 MB segment every 17 batches of 1,024,
    and those ``cudaMalloc`` calls stalled the window by 50-150 ms."""

    def __init__(self, seed: int, every: int, slots: int, batch: int,
                 k: int, device: torch.device):
        self.seed, self.every = seed, every
        self.d = torch.empty((slots, batch, k), dtype=torch.float32,
                             device=device)
        self.ids = torch.empty((slots, batch, k), dtype=torch.int64,
                               device=device)

    def wants(self, i: int, rec: "Units") -> bool:
        return (len(rec.kept) < self.d.shape[0]
                and data.sub_seed(self.seed, data.STREAM_SAMPLE, i + 1)
                % self.every == 0)

    def keep(self, i: int, d: torch.Tensor, ids: torch.Tensor,
             rec: "Units"):
        j = len(rec.kept)
        self.d[j].copy_(d)
        self.ids[j].copy_(ids)
        rec.kept[i] = j


class Workload:
    """A cell's engine, inputs and traffic: ``unit(i)`` submits the i-th
    unit of work (the i-th write step, if the mix writes, then the i-th
    search batch) without waiting for the card."""

    def __init__(self, cell: Cell, engine, gen: data.Generator,
                 pool: torch.Tensor, seed: int, device: torch.device):
        t = cell.traffic
        self.engine, self.gen, self.pool = engine, gen, pool
        self.seed, self.device = seed, device
        self.k, self.batch = int(t["k"]), int(t["batch"])
        w = t.get("writes")
        self.plan = None
        if w:
            self.plan = WritePlan(int(cell.config["rows"]), seed,
                                  int(w["overwrite"]), int(w["fresh"]),
                                  int(w["delete"]))
            wq = int(w["write_queries"])
            half = wq // 2
            # the write queries: half at overwritten rows, half at fresh
            self.wsel = torch.cat([
                torch.arange(half),
                int(w["overwrite"]) + torch.arange(wq - half)]).to(device)
        self.spans = False         # record_function spans (traced windows)
        self.sync_writes = False   # synchronized write spans

    @property
    def write_queries(self) -> int:
        return 0 if self.plan is None else int(self.wsel.shape[0])

    def _span(self, name: str):
        if self.spans:
            return torch.autograd.profiler.record_function(name)
        return contextlib.nullcontext()

    def queries(self, i: int, vec: Optional[torch.Tensor]) -> torch.Tensor:
        q = self.pool[i % self.pool.shape[0]]
        if vec is None:
            return q
        return torch.cat([q[:self.batch - self.write_queries],
                          vec[self.wsel]])

    def unit(self, i: int, rec: Units, clock: "Clock"):
        vec = None
        if self.plan is not None:
            if len(self.plan.steps) != i:
                raise RuntimeError(f"write step {i} out of order")
            up, dl = self.plan.step()
            vec = self.gen.writes(up.shape[0], self.seed, i)
            up_t, dl_t = _to_device(up, self.device), _to_device(dl,
                                                                 self.device)
            if self.sync_writes:
                sync(self.device)
            with self._span("bench.write"):
                t0 = time.perf_counter()
                self.engine.upsert(up_t, vec)
                self.engine.delete(dl_t)
                if self.sync_writes:
                    sync(self.device)
                rec.write_s.append(time.perf_counter() - t0)
        q = self.queries(i, vec)
        rec.submit.append(clock.now())
        with self._span("bench.search"):
            t0 = time.perf_counter()
            d, ids = self.engine.search(q, self.k)
            rec.search_host_s.append(time.perf_counter() - t0)
        return d, ids


def closed_loop(work: Workload, first: int, *, seconds: float = 0.0,
                units: int = 0, in_flight: int = 2,
                keeper: Optional[Keeper] = None) -> Units:
    """Submit units from ``first`` on, ``in_flight`` queued at most, for
    ``seconds`` (or ``units`` of them); wait for all and return what each
    recorded, its submission and completion times included; ``keeper``
    copies the marked units' answers after their completion marks."""
    clock = Clock(work.device)
    rec = Units(first=first)
    marks = collections.deque()
    clock.start()
    i = first
    while (clock.now() < seconds) if seconds else (i - first < units):
        if len(marks) >= in_flight:
            m = marks.popleft()
            with work._span("bench.wait"):
                clock.wait(m)
            rec.done.append(clock.at(m))
            clock.release(m)
        d, ids = work.unit(i, rec, clock)
        marks.append(clock.mark())
        if keeper is not None and keeper.wants(i, rec):
            keeper.keep(i, d, ids, rec)
        i += 1
    sync(work.device)
    rec.done.extend(clock.at(m) for m in marks)
    return rec


def _wrap_counting(module, name: str, calls: List[dict], keys):
    """Replace ``module.name`` by a wrapper that keeps references to the
    call's inputs named in ``keys`` (no device work); returns the restore
    function."""
    fn = getattr(module, name)
    import inspect
    sig = inspect.signature(fn)

    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        calls.append({k: bound.arguments.get(k) for k in keys})
        return fn(*args, **kwargs)

    wrapper.launches = fn.launches
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def build(cell: Cell, corpus: torch.Tensor, device: torch.device):
    """The engine of ``cell``'s configuration over ``corpus``."""
    from repro_torch.core.mpad import MPADConfig
    from repro_torch.search.serve import StreamConfig, build_engine
    e = cell.config["engine"]
    engine = build_engine(corpus, cell.config["spec"], device=device,
                          seed=int(e["seed"]),
                          fit_sample=int(e["fit_sample"]),
                          mpad=MPADConfig(**e["mpad"]))
    w = cell.traffic.get("writes")
    if w:
        s = dict(w["stream_config"])
        extra = s.pop("row_capacity_extra", None)
        if extra is not None:
            s["row_capacity"] = int(cell.config["rows"]) + int(extra)
        engine.streaming(StreamConfig(**s))
    return engine


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, *,
        engine_hook: Optional[Callable] = None, control: bool = False,
        readers: Optional[Dict] = None) -> dict:
    """One run; returns the result line's fields (``checks`` last)."""
    cfg, traffic = cell.config, cell.traffic
    n, k, batch = int(cfg["rows"]), int(traffic["k"]), int(traffic["batch"])
    gen = data.Generator(data.Recipe.from_config(cfg), device)
    corpus = gen.corpus(n)
    corpus_sum = data.checksum(corpus)
    pool = gen.queries(int(traffic["query_pool_batches"]) * batch,
                       seed).view(-1, batch, corpus.shape[1])
    sync(device)
    log(f"data: {n} x {corpus.shape[1]} corpus and "
        f"{pool.shape[0]} x {batch} queries in "
        f"{time.perf_counter() - t_start:.2f} s since start")
    if control:
        return _control(cell, seed, device, gen, corpus, corpus_sum, pool)
    engine = build(cell, corpus, device)
    if engine_hook is not None:
        engine = engine_hook(engine)
    if traffic.get("writes"):
        # the store holds its own copy of every row; the reference draws
        # the corpus again after the window
        corpus.untyped_storage().resize_(0)
    del corpus
    work = Workload(cell, engine, gen, pool, seed, device)
    kp = traffic["keep"]
    keeper = Keeper(seed, int(kp["every"]), int(kp["slots"]), batch, k,
                    device)
    sync(device)
    log(f"engine built in {time.perf_counter() - t_start:.2f} s since "
        f"start: {getattr(engine, 'build_seconds', {})}")
    # the build's cached blocks go back to the card, so the window's
    # allocations are the warm-up's
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # warm every shape the window uses (the writes are the schedule's
    # first steps; a compaction warms the fold)
    warm = int(traffic["warm_units"])
    closed_loop(work, 0, units=warm)
    if traffic.get("writes") and traffic["writes"].get("warm_compact"):
        engine.compact()
        closed_loop(work, warm, units=1)
        warm += 1
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    # what set-up made is never garbage: a full collection in the window
    # then scans only what the window made (~0.1 s a pass otherwise, with
    # torch's objects in the heap), as a serving process that freezes its
    # start-up heap does
    gc.collect()
    gc.freeze()
    comp0 = engine.counters.get("compactions", 0)
    win = closed_loop(work, warm, seconds=seconds,
                      in_flight=int(traffic["in_flight"]), keeper=keeper)
    comps = engine.counters.get("compactions", 0) - comp0
    n_units = len(win.submit)
    window_s = max(win.done) if win.done else seconds
    lat_ms = 1e3 * (np.asarray(win.done) - np.asarray(win.submit))
    log(f"window: {n_units} batches in {window_s:.3f} s, "
        f"{comps} compactions")

    traced_read = None
    k_calls: Dict[str, List[dict]] = {"k1": [], "k2": []}
    write_sync_ms = []
    if traced:
        traced_read, write_sync_ms = _traced(
            work, warm + n_units, traffic, k_calls)
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)

    # the sample the comparison reads, drawn from the seed, copied off
    # before the program's state is freed
    sample = judge.draw_sample(win, work, seed, traffic, keeper)
    steps = list(work.plan.steps) if work.plan is not None else None
    upserts = work.plan.upserts if work.plan is not None else 0
    del work, engine, win, keeper
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    corpus = gen.corpus(n)
    if data.checksum(corpus) != corpus_sum:
        raise RuntimeError("the regenerated corpus differs from the served "
                           "one")
    numbers = judge.compare(sample, gen, seed, corpus, steps, upserts, k)
    log(f"reference and comparison {time.perf_counter() - t_ref:.2f} s")
    checks = judge.checks(numbers, cfg["checks"])

    queries = n_units * batch
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": n_units, "failed": 0, "metrics": {},
        "device": device_block(device, peak)}
    if not traced:
        e2e = {"qps": (queries / window_s, "queries/s"),
               "p95_ms": (float(np.percentile(lat_ms, 95)), "ms"),
               "recall_at_10": (numbers["recall_at_10"], "ratio"),
               "setup_s": (setup_s, "s")}
        if steps is not None:
            rows = n_units * (upserts + int(traffic["writes"]["delete"]))
            e2e["write_rows_per_s"] = (rows / window_s, "rows/s")
        for m in cell.end_to_end:
            v, unit = e2e[m["name"]]
            result["metrics"][m["name"]] = {"value": v, "unit": unit}
        p50 = float(np.percentile(lat_ms, 50))
        top = np.argsort(lat_ms)[::-1][:4]
        slow = lat_ms > 3 * p50
        host_ms = 1e3 * np.asarray(sample.search_host_s)
        log(f"latency ms: p50 {p50:.3f} p95 {np.percentile(lat_ms, 95):.3f}"
            f"; {int(slow.sum())} batches over 3x p50, "
            f"{float((lat_ms[slow] - p50).sum()):.1f} ms beyond p50; "
            "largest " + ", ".join(
                f"{lat_ms[i]:.2f} (batch {i}, host {host_ms[i]:.2f})"
                for i in top))
        log(f"peak memory {peak / 1e9:.3f} GB")
    else:
        record = Record(cell=cell, search_host_s=sample.search_host_s,
                        latency_ms=list(lat_ms),
                        trace=traced_read, k1_calls=k_calls["k1"],
                        k2_calls=k_calls["k2"], compactions=comps,
                        write_sync_ms=write_sync_ms)
        for name, mod in (readers or {}).items():
            v = mod.read(record)
            if v is None:
                log(f"metric {name}: nothing to read")
                continue
            result["metrics"][name] = {"value": float(v), "unit": mod.UNIT}
        if traced_read is not None:
            result["device"]["busy_s"] = traced_read.busy_s
            result["device"]["window_s"] = traced_read.window_s
            result["breakdown"] = {"device_ops": traced_read.device_ops,
                                   "idle_gaps": traced_read.idle_gaps}
    result["checks"] = checks
    return result


@dataclasses.dataclass
class Record:
    """What a per-layer metric's reader reads (``bench/metrics``)."""
    cell: Cell
    search_host_s: List[float]      # host span of each search call
    latency_ms: List[float]         # each window batch's latency
    trace: Optional[trace.TraceRead]
    k1_calls: List[dict]
    k2_calls: List[dict]
    compactions: int                # engine.counters["compactions"] delta
    write_sync_ms: List[float]      # synchronized write step spans


def _traced(work: Workload, first: int, traffic: dict,
            k_calls: Dict[str, List[dict]]):
    """After the window: a profiled window of ``trace.units`` units, run as
    the window runs them, with K1's and K2's inputs kept for their counts;
    then, in a cell that writes, ``trace.write_sync_units`` units with
    synchronized write spans."""
    from repro_torch.kernels.pq_adc import ops
    t = traffic["trace"]
    nxt = [first]

    def run_units():
        rec = closed_loop(work, nxt[0], units=int(t["units"]),
                          in_flight=int(traffic["in_flight"]))
        nxt[0] += int(t["units"])
        return rec

    def attempt():
        for v in k_calls.values():
            v.clear()
        run_units()

    k1a, k1b, k2 = (ops.pq_adc_cells_topk, ops.pq_adc_gather_topk,
                    ops.pq_adc_topk)

    def counters():
        return {"adc_select<": k1a.launches + k1b.launches,
                "adc_shared_select<": k2.launches}

    restore = [
        _wrap_counting(ops, "pq_adc_cells_topk", k_calls["k1"],
                       ("tables", "probe", "cell_len", "codes_cell", "k",
                        "live")),
        _wrap_counting(ops, "pq_adc_topk", k_calls["k2"],
                       ("tables", "codes", "k"))]
    work.spans = True
    try:
        read = trace.profile_window(attempt, counters, log,
                                    lambda: sync(work.device),
                                    need_device=work.device.type == "cuda")
    finally:
        work.spans = False
        for r in restore:
            r()
    write_ms = []
    if work.plan is not None and int(t.get("write_sync_units", 0)):
        work.sync_writes = True
        rec = closed_loop(work, nxt[0], units=int(t["write_sync_units"]),
                          in_flight=int(traffic["in_flight"]))
        work.sync_writes = False
        write_ms = [1e3 * s for s in rec.write_s]
    return read, write_ms


def _control(cell, seed, device, gen, corpus, corpus_sum, pool) -> dict:
    """The control: the reference one precision lower (TF32) in the
    program's place, over a schedule of ``control_units`` units, judged as
    a run is."""
    traffic = cell.traffic
    k, batch = int(traffic["k"]), int(traffic["batch"])
    work = Workload(cell, None, gen, pool, seed, device)
    units = int(traffic["control_units"])
    rec = Units(first=0)
    for i in range(units):
        if work.plan is not None:
            work.plan.step()
        rec.submit.append(0.0)
        rec.kept[i] = i
    rec.search_host_s = [0.0] * units
    sample = judge.draw_sample(rec, work, seed, traffic)
    steps = list(work.plan.steps) if work.plan is not None else None
    upserts = work.plan.upserts if work.plan is not None else 0
    numbers = judge.compare(sample, gen, seed, corpus, steps, upserts, k,
                            control=True)
    checks = judge.checks(numbers, cell.config["checks"])
    return {"correct": all(c["ok"] for c in checks.values()),
            "attempted": units, "failed": 0, "metrics": {},
            "device": device_block(device, 0), "checks": checks}


def device_block(device: torch.device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
