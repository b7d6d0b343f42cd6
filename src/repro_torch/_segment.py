"""A segment sum that repeats bit for bit on every device.

``index_add_`` on a CUDA tensor adds with float atomics, in an order that
changes from run to run, so k-means centroids and UMAP embeddings built
on it do not repeat. On a CUDA tensor ``SegmentSum`` adds in a fixed
order instead, the JAX package's way (``onehot_segment_sum``): the
one-hot matrix of a chunk of rows times that chunk (a plain matmul), the
chunks added one after another. The products run in float64, which no
TF32 setting touches, so the result does not depend on how the caller
set ``torch.backends.cuda.matmul``. On the CPU ``index_add_`` already
adds in row order, with no atomics, and the port keeps it there, into the
caller's base as JAX's ``.at[].add`` does: the CPU results the tests hold
against JAX stay as they were.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

__all__ = ["SegmentSum", "segment_sum", "onehot_segment_sum"]

# entries of one chunk's one-hot matrix: 128 MB in f64
_ONEHOT_ENTRIES = 1 << 24
# the one-hot chunks a SegmentSum keeps on the card for reuse, at most
_KEEP_BYTES = 2 << 30


def _onehot_chunks(segments: torch.Tensor,
                   num_segments: int) -> Iterator[torch.Tensor]:
    """The (num_segments, rows) f64 one-hot matrices of segments' row
    chunks, in row order."""
    ids = torch.arange(num_segments, device=segments.device)[:, None]
    rows = max(1, _ONEHOT_ENTRIES // max(1, num_segments))
    for s in range(0, segments.shape[0], rows):
        yield (segments[None, s:s + rows] == ids).to(torch.float64)


def onehot_segment_sum(values: torch.Tensor, segments: torch.Tensor,
                       num_segments: int,
                       base: Optional[torch.Tensor] = None, *,
                       onehots=None) -> torch.Tensor:
    """The fixed-order sum on any device: base + out, out[s] = the sum of
    values[i] over the rows i with segments[i] == s, as f64 one-hot
    products of row chunks added chunk after chunk, rounded to values'
    dtype once. Products of a 0 or 1 are exact and the order of the sums
    is fixed (the matmul's within a chunk, then chunk after chunk), so a
    call repeats bit for bit. ``onehots``: the chunks of
    ``_onehot_chunks``, made before (``SegmentSum`` keeps them)."""
    n = values.shape[0]
    flat = values.reshape(n, -1)
    out = (flat.new_zeros((num_segments, flat.shape[1]), dtype=torch.float64)
           if base is None else base.reshape(num_segments, -1).double())
    rows = max(1, _ONEHOT_ENTRIES // max(1, num_segments))
    if onehots is None:
        onehots = _onehot_chunks(segments, num_segments)
    for s, onehot in zip(range(0, n, rows), onehots):
        out += onehot @ flat[s:s + rows].double()
    return out.to(values.dtype).reshape((num_segments,)
                                        + tuple(values.shape[1:]))


class SegmentSum:
    """Sums by one segment vector, for one or many values: ``self(values,
    base)`` is base + out, out[s] = the sum of values[i] over the rows i
    with segments[i] == s (segments (N,) int in [0, num_segments); values
    (N, ...) float; base (num_segments, ...) or None for zeros), in an
    order that is the same on every run: ``index_add`` into base (row
    order) on the CPU, ``onehot_segment_sum`` on a CUDA tensor. On the card
    it makes the one-hot chunks once and keeps them when they take at most
    ``_KEEP_BYTES`` (UMAP sums over the same edges a thousand times a
    fit), else it makes them anew in each call."""

    def __init__(self, segments: torch.Tensor, num_segments: int):
        self.segments, self.num_segments = segments, num_segments
        self._onehots = None
        if (segments.device.type == "cuda"
                and 8 * segments.shape[0] * num_segments <= _KEEP_BYTES):
            self._onehots = list(_onehot_chunks(segments, num_segments))

    def __call__(self, values: torch.Tensor,
                 base: Optional[torch.Tensor] = None) -> torch.Tensor:
        if values.device.type == "cuda":
            return onehot_segment_sum(values, self.segments,
                                      self.num_segments, base,
                                      onehots=self._onehots)
        if base is None:
            base = values.new_zeros((self.num_segments,)
                                    + tuple(values.shape[1:]))
        return base.index_add(0, self.segments, values)


def segment_sum(values: torch.Tensor, segments: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = the sum of values[i] over the rows i with segments[i] == s,
    in an order that is the same on every run (``SegmentSum`` of one
    call)."""
    return SegmentSum(segments, num_segments)(values)
