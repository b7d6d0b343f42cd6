"""Reading a torch.profiler trace of a short window of the cell's work.

The window runs under ``torch.profiler`` with the benchmark's own spans
(``record_function``): ``bench.window`` around all of it, ``bench.search``
around each search call, ``bench.write`` around each write step and
``bench.wait`` around each wait for a batch in flight. The trace is
exported as Chrome-trace JSON and read here:

* device activity: kernels, copies and sets, their union (busy time)
  within the window, and time by kernel name;
* host-side kernel launches (the CUDA runtime's and driver's launch
  calls) inside the search spans;
* the device's idle gaps, each named by what the host was doing at its
  middle: the innermost benchmark span and the innermost operator.

A profiler on this card now and then drops kernel records. So the caller
names, for each kernel it can count (a name fragment and the launches the
port's wrappers counted in the window), what the trace must hold; a trace
that holds fewer is marked ``lost`` and is retried, and never read as a
smaller time.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPANS = ("bench.search", "bench.write", "bench.wait")
ATTEMPTS = 3
TOP = 10


@dataclasses.dataclass
class TraceRead:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]      # (name, start us, dur us)
    n_search: int
    launches_in_search: int
    device_ops: List[List]                       # [[name, seconds], ...]
    idle_gaps: List[List]                        # [[host activity, s], ...]
    lost: Dict[str, Dict[str, int]]

    def kernel_seconds(self, *fragments: str) -> float:
        return sum(d for n, _, d in self.kernels
                   if any(f in n for f in fragments)) / 1e6

    def kernel_count(self, fragment: str) -> int:
        return sum(1 for n, _, _ in self.kernels if fragment in n)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Innermost:
    """The innermost of nested spans that holds a time: among spans that
    start at or before it, the latest-starting one that has not ended
    (nested spans start after their parents)."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: float, reach: int = 256) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - reach), -1):
            s, e, name = self.spans[j]
            if e >= t:
                return name
        return None


def read_chrome_trace(data: dict, expect: Dict[str, int]) -> TraceRead:
    """Read a Chrome-trace dict (``export_chrome_trace``'s JSON).
    ``expect`` maps a kernel-name fragment to the launches counted in the
    window."""
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    wins = [e for e in events if e.get("name") == "bench.window"
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise ValueError("the trace holds no bench.window span")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev = [(e["name"], float(e["ts"]), float(e.get("dur", 0)))
           for e in events if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) < w1]
    merged = _union([(s, min(s + d, w1)) for _, s, d in dev])
    busy_us = sum(e - s for s, e in merged)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in SPANS]
    searches = _Innermost([sp for sp in spans if sp[2] == "bench.search"])
    in_search = sum(1 for e in events if e.get("cat") in LAUNCH_CATS
                    and "LaunchKernel" in e.get("name", "")
                    and searches.at(float(e["ts"])) is not None)
    by_name: Dict[str, float] = defaultdict(float)
    for n, _, d in dev:
        by_name[n] += d / 1e6
    ops = _Innermost([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("cat") == "cpu_op"])
    host = _Innermost(spans)
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = 0.5 * (s + e)
            label = host.at(mid) or "host"
            op = ops.at(mid)
            gaps[f"{label}/{op}" if op else label] += (e - s) / 1e6
    lost = {}
    for frag, launched in expect.items():
        traced = sum(1 for n, _, _ in dev if frag in n)
        if traced < launched:
            lost[frag] = {"launched": launched, "traced": traced}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gtop = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceRead(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                     kernels=dev, n_search=len(searches.spans),
                     launches_in_search=in_search,
                     device_ops=[[n, v] for n, v in top],
                     idle_gaps=[[n, v] for n, v in gtop], lost=lost)


def profile_window(run: Callable[[], None], expect: Callable[[], Dict],
                   log: Callable[[str], None],
                   sync: Callable[[], None],
                   need_device: bool = True) -> TraceRead:
    """Trace ``run()`` (which makes the spans and ends synchronized) up to
    ``ATTEMPTS`` times until no counted kernel lost a record. ``expect()``
    is called before and after each attempt and returns the launch
    counters (fragment -> count); the window's expectation is their
    difference. Returns the first complete read, else the one that lost
    the fewest records, with ``lost`` set. ``sync`` waits for the
    device; without ``need_device`` (a CPU run) a trace with no device
    time is complete."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    best = None
    for attempt in range(1, ATTEMPTS + 1):
        before = expect()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                run()
                sync()
        after = expect()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        read = read_chrome_trace(
            data, {k: after[k] - before.get(k, 0) for k in after})
        if (read.busy_s > 0 or not need_device) and not read.lost:
            return read
        missing = sum(v["launched"] - v["traced"] for v in read.lost.values())
        log(f"trace attempt {attempt}: busy {read.busy_s:.6f} s, "
            f"lost records {read.lost}")
        if read.busy_s > 0 and (best is None or missing < best[0]):
            best = (missing, read)
    if best is None:
        raise RuntimeError("the profiler recorded no device time in "
                           f"{ATTEMPTS} traces")
    return best[1]
