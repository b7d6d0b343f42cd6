"""Deterministic, restart-safe data pipeline (port of the LM part of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step, shard): a restart from a
checkpoint at step k replays the identical stream from k, and a replaced
host recomputes exactly its shard. ``jax.random`` streams cannot be
reproduced here, so each batch is drawn from a CPU ``torch.Generator``
seeded by ``np.random.SeedSequence([seed, step, shard])`` and then moved
to the device: the stream is the same on the CPU and on the card.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

__all__ = ["deterministic_shard", "lm_token_batches"]


def deterministic_shard(seed: int, step: int, shard: int) -> torch.Generator:
    """The per-(step, shard) generator: the whole coordination protocol."""
    state = np.random.SeedSequence([seed, step, shard]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def lm_token_batches(seed: int, batch: int, seq: int, vocab: int,
                     shard: int = 0, n_steps: Optional[int] = None,
                     device: DeviceLike = None
                     ) -> Iterator[Dict[str, torch.Tensor]]:
    """Zipf(1.1) synthetic token stream over ``vocab`` ids (id r - 1 has
    probability proportional to r^-1.1); yields ``{"tokens", "labels"}``,
    each (batch, seq) int64, the labels the tokens shifted by one. Runs on
    ``cuda`` unless ``device`` names another device."""
    dev = resolve_device(device)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs = torch.from_numpy(probs / probs.sum())
    step = 0
    while n_steps is None or step < n_steps:
        toks = torch.multinomial(
            probs, batch * (seq + 1), replacement=True,
            generator=deterministic_shard(seed, step, shard)
        ).reshape(batch, seq + 1).to(dev)
        yield {"tokens": toks[:, :-1].contiguous(),
               "labels": toks[:, 1:].contiguous()}
        step += 1
