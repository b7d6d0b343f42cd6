"""The write schedule of a stream mix, and the live-row bookkeeping the
reference reads.

Each step overwrites ``overwrite`` live ids, adds ``fresh`` new ids and
deletes ``delete`` live ids, all distinct, drawn from ``--seed`` on the
host (numpy): the live set keeps its size when ``fresh == delete``. The
ids of step ``s`` depend only on the seed and the steps before it, so the
schedule is the same whatever the card's speed; the vectors are drawn on
the card from the step's own seed (``data.Generator.writes``).

``Ledger`` replays the schedule after the window into the reference's row
space: row ``r < n`` is corpus row ``r``; the ``j``-th upserted row of
step ``s`` is row ``n + s * upserts + j``. Each row gets its live
interval [start, end) in steps; ``rows_at`` maps ids to the rows live
at a step (-1 for an id that is dead or was never written).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .data import STREAM_WRITES, sub_seed

NEVER = np.iinfo(np.int64).max


class WritePlan:
    """The ids of every step, made in order on the host."""

    def __init__(self, n_live: int, seed: int, overwrite: int, fresh: int,
                 delete: int):
        if overwrite + delete > n_live:
            raise ValueError("a step touches more ids than are live")
        self.overwrite, self.fresh, self.delete = overwrite, fresh, delete
        self.pool = np.arange(n_live, dtype=np.int64)   # the live ids
        self.next_id = n_live
        self.rng = np.random.default_rng(sub_seed(seed, STREAM_WRITES))
        self.steps: List[Tuple[np.ndarray, np.ndarray]] = []

    @property
    def upserts(self) -> int:
        return self.overwrite + self.fresh

    def step(self) -> Tuple[np.ndarray, np.ndarray]:
        """The next step's (upsert ids, delete ids): the overwritten ids,
        then the fresh ones; deleted slots of the pool take the fresh
        ids."""
        n_touch = self.overwrite + self.delete
        pos = self.rng.choice(self.pool.shape[0], n_touch, replace=False)
        ow = self.pool[pos[:self.overwrite]].copy()
        dl = self.pool[pos[self.overwrite:]].copy()
        fresh = np.arange(self.next_id, self.next_id + self.fresh,
                          dtype=np.int64)
        self.next_id += self.fresh
        keep = min(self.fresh, self.delete)
        self.pool[pos[self.overwrite:self.overwrite + keep]] = fresh[:keep]
        if self.fresh > keep:
            self.pool = np.concatenate([self.pool, fresh[keep:]])
        elif self.delete > keep:
            self.pool = np.delete(self.pool, pos[self.overwrite + keep:])
        up = np.concatenate([ow, fresh])
        self.steps.append((up, dl))
        return up, dl


class Ledger:
    """The reference's row space for ``n`` corpus rows and the first
    ``last + 1`` steps of a plan (``last`` -1: the corpus alone)."""

    def __init__(self, n: int, steps: List[Tuple[np.ndarray, np.ndarray]],
                 upserts: int, last: int):
        n_rows = n + (last + 1) * upserts
        self.last = last
        self.start = np.full(n_rows, -1, dtype=np.int64)
        self.end = np.full(n_rows, NEVER, dtype=np.int64)
        self.row_id = np.concatenate(
            [np.arange(n, dtype=np.int64)]
            + [up for up, _ in steps[:last + 1]])
        cur = np.full(int(self.row_id.max(initial=n - 1)) + 1, -1,
                      dtype=np.int64)
        cur[:n] = np.arange(n)
        for s in range(last + 1):
            up, dl = steps[s]
            rows = n + s * upserts + np.arange(up.shape[0])
            old = cur[up]
            self.end[old[old >= 0]] = s
            cur[up] = rows
            self.start[rows] = s
            old = cur[dl]
            self.end[old[old >= 0]] = s
            cur[dl] = -1
        self.n = n
        if last < 0:
            return
        # rows ordered by (id, start): an id's live row at a step is the
        # last of its rows that started by then, if it has not ended
        self._span = last + 3
        self._order = np.lexsort((self.start, self.row_id))
        self._key = (self.row_id[self._order] * self._span
                     + self.start[self._order] + 1)

    def rows_at(self, step: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """The row live for each id at its query's step (``step`` (Q,),
        ``ids`` (Q, k)); -1 for a dead, unknown or -1 id."""
        if self.last < 0:
            return np.where((ids >= 0) & (ids < self.n), ids, -1)
        # no event follows the last step replayed
        step = np.minimum(np.asarray(step, np.int64), self.last + 1)
        step = np.broadcast_to(step[:, None],
                               ids.shape)
        ok = ids >= 0
        key = np.where(ok, ids, 0) * self._span + step + 1
        pos = np.searchsorted(self._key, key, side="right") - 1
        row = self._order[np.clip(pos, 0, None)]
        live = (ok & (pos >= 0) & (self.row_id[row] == ids)
                & (self.start[row] <= step) & (step < self.end[row]))
        return np.where(live, row, -1)
