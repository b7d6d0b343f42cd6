"""Maintenance policy: when to compact, vacuum, grow, or retrain (a copy
of ``repro.search.durability.policy``; host Python, no tensors).

A streaming engine degrades along three axes the write path itself never
fixes:

* **tombstone density**: deletes and overwrites mask base rows out of
  the scan but never reclaim them. ``decide_delete`` routes dense-enough
  bitmaps into a **vacuum** (the base rewritten over the survivors with
  the frozen quantizers, no retraining).
* **capacity pressure**: compaction appends into pre-allocated slack;
  ``decide_post_compact`` can grow the store before a fold overflows
  (off by default: ``grow_headroom=0``).
* **quantizer drift**: the PQ codebooks are frozen at build time. The
  policy tracks the reconstruction error of newly folded rows against
  the build-time baseline (per-kind ``IndexOps.drift_stats``) and, when
  the ratio passes ``drift_ratio`` and the error clears the LUT noise
  floor (``repro_torch.kernels.pq_adc.lut.lut_error_bound``), advises or
  (``auto_rebuild=True``) triggers a quantizer rebuild.

Decisions are data, not actions: the engine executes them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["PolicyConfig", "MaintenancePolicy", "Decision"]


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Maintenance thresholds (``StreamConfig.policy``)."""
    tombstone_density: float = 0.25  # vacuum when dead/allocated exceeds
    tombstone_min_dead: int = 64     # ... and at least this many are dead
    delta_fill: Optional[float] = None   # auto-compact fill fraction;
    #                                      None = StreamConfig
    #                                      .compact_threshold
    grow_headroom: float = 0.0       # grow the base after compaction when
    #                                  free rows < headroom * delta
    #                                  capacity (0 disables)
    drift_ratio: float = 4.0         # rebuild when recent encode error
    #                                  exceeds this multiple of the
    #                                  build-time baseline
    drift_min_rows: int = 256        # ... measured over at least this
    #                                  many folded rows
    auto_rebuild: bool = False       # False: surface "advise_rebuild" in
    #                                  metrics; True: rebuild through
    #                                  build_engine automatically
    recall_floor: Optional[float] = None  # advise/trigger a rebuild when
    #                                  the online recall estimate
    #                                  (Tracer shadow-exact EMA, fed via
    #                                  observe_recall) drops below this
    #                                  (None disables; needs
    #                                  engine.tracing(recall_every=N))
    recall_min_samples: int = 8      # ... after at least this many
    #                                  shadow-exact samples (one noisy
    #                                  sample must not trigger retrains)

    def __post_init__(self):
        if not (0.0 < self.tombstone_density <= 1.0):
            raise ValueError("tombstone_density must be in (0, 1]")
        if self.tombstone_min_dead < 1:
            raise ValueError("tombstone_min_dead must be >= 1")
        if self.delta_fill is not None and not (0.0 < self.delta_fill <= 1.0):
            raise ValueError("delta_fill must be in (0, 1]")
        if self.grow_headroom < 0:
            raise ValueError("grow_headroom must be >= 0")
        if self.drift_ratio <= 1.0:
            raise ValueError("drift_ratio must be > 1")
        if self.drift_min_rows < 1:
            raise ValueError("drift_min_rows must be >= 1")
        if (self.recall_floor is not None
                and not 0.0 < self.recall_floor <= 1.0):
            raise ValueError("recall_floor must be in (0, 1]")
        if self.recall_min_samples < 1:
            raise ValueError("recall_min_samples must be >= 1")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One maintenance verdict: what to do, why, and with what params."""
    kind: str                        # "none" | "vacuum" | "grow" |
    #                                  "rebuild" | "advise_rebuild"
    reason: str = ""
    params: dict = dataclasses.field(default_factory=dict)


_NONE = Decision("none")


class MaintenancePolicy:
    """Stateful tracker + decider over one streaming engine's lifetime.

    The engine feeds it observations (build-time baseline encode error,
    per-compaction encode error of the folded delta rows, tombstone and
    capacity counts at decision points, and — when a ``Tracer`` runs
    shadow-exact sampling — the online recall estimate); it returns
    ``Decision``s and keeps per-kind counters for
    ``SearchEngine.metrics()``.
    """

    def __init__(self, config: Optional[PolicyConfig] = None):
        self.config = config or PolicyConfig()
        self.base_error: Optional[float] = None
        self.recent_error: Optional[float] = None
        self.recent_rows = 0
        self.recall_ema: Optional[float] = None
        self.recall_k: Optional[int] = None
        self.recall_samples = 0
        self.decisions: dict = {}

    # --- observations ----------------------------------------------------

    def observe_build_error(self, err: float):
        """(Re)base the drift reference: mean squared reconstruction
        error of the build-time rows under the (re)trained quantizers."""
        self.base_error = float(err)
        self.recent_error = None
        self.recent_rows = 0

    def observe_encode_error(self, err: float, n_rows: int):
        """Fold one compaction's mean encode error into the recent
        estimate (exponential blend so old batches age out)."""
        if n_rows <= 0:
            return
        err = float(err)
        if self.recent_error is None:
            self.recent_error = err
        else:
            self.recent_error = 0.5 * (self.recent_error + err)
        self.recent_rows += int(n_rows)

    def observe_recall(self, recall: float, k: int):
        """Fold one shadow-exact recall sample into the policy's view of
        serving quality (the ``Tracer`` calls this on every sampled
        query when a policy is configured). The EMA here intentionally
        mirrors the tracer's gauge: the policy must act on the same
        number the dashboards show."""
        a = 0.1
        recall = float(recall)
        self.recall_ema = (recall if self.recall_ema is None
                           else a * recall + (1.0 - a) * self.recall_ema)
        self.recall_k = int(k)
        self.recall_samples += 1

    def drift_ratio(self) -> Optional[float]:
        """recent/base encode-error ratio; None until both observed."""
        if (self.base_error is None or self.recent_error is None
                or self.base_error <= 0.0):
            return None
        return self.recent_error / self.base_error

    # --- decision points --------------------------------------------------

    def _emit(self, decision: Decision) -> Decision:
        if decision.kind != "none":
            self.decisions[decision.kind] = (
                self.decisions.get(decision.kind, 0) + 1)
        return decision

    def decide_delete(self, *, dead: int, allocated: int) -> Decision:
        """After a delete batch: vacuum when the tombstone bitmap is
        dense enough that the masked base scan is mostly waste."""
        c = self.config
        if (allocated > 0 and dead >= c.tombstone_min_dead
                and dead / allocated > c.tombstone_density):
            return self._emit(Decision(
                "vacuum",
                f"tombstones {dead}/{allocated} exceed density "
                f"{c.tombstone_density}"))
        return _NONE

    def decide_post_compact(self, *, free_rows: int, delta_capacity: int,
                            noise_floor: float = 0.0) -> Decision:
        """After a compaction: retrain on drift first (it re-provisions
        capacity anyway), else grow proactively if headroom ran out."""
        c = self.config
        ratio = self.drift_ratio()
        if (ratio is not None and self.recent_rows >= c.drift_min_rows
                and ratio > c.drift_ratio
                and (self.recent_error or 0.0) > float(noise_floor)):
            kind = "rebuild" if c.auto_rebuild else "advise_rebuild"
            return self._emit(Decision(
                kind, f"encode-error drift {ratio:.2f}x over "
                      f"{self.recent_rows} rows (threshold "
                      f"{c.drift_ratio}x)"))
        if (c.recall_floor is not None and self.recall_ema is not None
                and self.recall_samples >= c.recall_min_samples
                and self.recall_ema < c.recall_floor):
            kind = "rebuild" if c.auto_rebuild else "advise_rebuild"
            return self._emit(Decision(
                kind, f"online recall estimate {self.recall_ema:.3f}@"
                      f"{self.recall_k} below floor {c.recall_floor} "
                      f"({self.recall_samples} shadow samples)"))
        if c.grow_headroom > 0 and free_rows < c.grow_headroom * delta_capacity:
            return self._emit(Decision(
                "grow", f"free rows {free_rows} below headroom "
                        f"{c.grow_headroom} x {delta_capacity}",
                {"row_extra": 4 * delta_capacity,
                 "cell_extra": delta_capacity}))
        return _NONE

    def stats(self) -> dict:
        """Counters + drift/recall state for ``SearchEngine.metrics()``."""
        return {"decisions": dict(self.decisions),
                "base_error": self.base_error,
                "recent_error": self.recent_error,
                "recent_rows": self.recent_rows,
                "drift_ratio": self.drift_ratio(),
                "recall_ema": self.recall_ema,
                "recall_samples": self.recall_samples}
