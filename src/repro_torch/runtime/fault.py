"""Fault tolerance: checkpoint/restart driver and failure injection (port
of ``repro.runtime.fault``).

``run_with_restarts`` checkpoints every ``ckpt_every`` steps and, on a
step's failure, resumes from the newest checkpoint and replays: the
deterministic data pipeline (``repro_torch.data.pipeline``) gives the
replayed stream, so on one device a restart reproduces the uninterrupted
run bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import torch

from repro_torch._tree import tree_map

from .checkpoint import (checkpoint_step, latest_checkpoint,
                         restore_checkpoint, save_checkpoint)

__all__ = ["FailureInjector", "run_with_restarts"]


class FailureInjector:
    """Raises RuntimeError at the given fail points (once each): global
    step numbers of the ``run_with_restarts`` loop, or string labels."""

    def __init__(self, fail_at: Iterable = ()):
        self.fail_at = set(fail_at)

    def maybe_fail(self, step):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected failure at step {step}")


def _copy(leaf):
    return leaf.detach().clone() if isinstance(leaf, torch.Tensor) else leaf


def run_with_restarts(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    n_steps: int,
    ckpt_dir: str,
    *,
    ckpt_every: int = 10,
    keep: int = 3,
    injector: Optional[FailureInjector] = None,
    max_restarts: int = 10,
) -> Any:
    """Run ``state = step_fn(state, step)`` for ``n_steps`` with checkpoint
    and restart. Returns the final state. A restart resumes from the
    newest checkpoint, or from ``init_state`` if there is none.

    The port's step functions update tensors in place (``adamw_update``),
    so a run from scratch starts on a copy of ``init_state``, which stays
    as it was given: the start of every attempt and the template every
    restore reads into."""
    restarts = 0
    while True:
        path = latest_checkpoint(ckpt_dir)
        if path is not None:
            state = restore_checkpoint(path, init_state)
            start = checkpoint_step(path) + 1
        else:
            state, start = tree_map(_copy, init_state), 0
        try:
            for step in range(start, n_steps):
                if injector is not None:
                    injector.maybe_fail(step)
                state = step_fn(state, step)
                if (step + 1) % ckpt_every == 0 or step == n_steps - 1:
                    save_checkpoint(ckpt_dir, step, state, keep=keep)
            return state
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
