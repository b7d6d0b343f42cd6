"""Deterministic, restart-safe data pipeline (port of
``repro.data.pipeline``): the LM token stream and the recsys batches.

Every batch is a pure function of (seed, step, shard): a restart from a
checkpoint at step k replays the identical stream from k, and a replaced
host recomputes exactly its shard. ``jax.random`` streams cannot be
reproduced here, so each batch is drawn from a CPU ``torch.Generator``
seeded by ``np.random.SeedSequence([seed, step, shard])`` and then moved
to the device: the stream is the same on the CPU and on the card.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, cpu_generator, resolve_device

__all__ = ["deterministic_shard", "lm_token_batches", "recsys_ranking_batch",
           "twotower_batch"]

SeedLike = Union[int, torch.Generator]


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


def _draws(seed: SeedLike) -> torch.Generator:
    return seed if isinstance(seed, torch.Generator) else cpu_generator(seed)


def _randint(gen, shape, high):
    return torch.randint(0, high, shape, generator=gen, dtype=torch.int32)


def recsys_ranking_batch(seed: SeedLike, batch: int, seq_len: int,
                         n_items: int, n_cats: int = 1000,
                         device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A DIEN-style ranking batch (JAX's fields, shapes and dtypes: int32
    ids, an f32 0/1 label), drawn on the CPU from ``seed`` (an int or a
    CPU ``torch.Generator``) and moved to the device: ``cuda`` unless
    ``device`` names another."""
    dev = resolve_device(device)
    gen = _draws(seed)
    out = {
        "hist_items": _randint(gen, (batch, seq_len), n_items),
        "hist_cats": _randint(gen, (batch, seq_len), n_cats),
        "target_item": _randint(gen, (batch,), n_items),
        "target_cat": _randint(gen, (batch,), n_cats),
        "neg_items": _randint(gen, (batch, seq_len), n_items),
        "neg_cats": _randint(gen, (batch, seq_len), n_cats),
        "label": (torch.rand((batch,), generator=gen) > 0.5).float(),
    }
    return {k: v.to(dev) for k, v in out.items()}


def twotower_batch(seed: SeedLike, batch: int, n_users: int, n_items: int,
                   n_hist: int, n_neg: int,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A two-tower training batch (JAX's fields, shapes and dtypes), drawn
    as ``recsys_ranking_batch`` draws; ``neg_logq`` is the log of the
    uniform sampling probability 1 / n_items."""
    dev = resolve_device(device)
    gen = _draws(seed)
    out = {
        "user_ids": _randint(gen, (batch,), n_users),
        "hist_ids": _randint(gen, (batch, n_hist), n_items),
        "pos_items": _randint(gen, (batch,), n_items),
        "neg_items": _randint(gen, (n_neg,), n_items),
        "neg_logq": torch.full((n_neg,), -float(np.log(n_items)),
                               dtype=torch.float32),
    }
    return {k: v.to(dev) for k, v in out.items()}
