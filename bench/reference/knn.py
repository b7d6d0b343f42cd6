"""The plain reference: exact k-NN over a row space that changes in time.

Plain PyTorch, float32 with TF32 off, in blocks of rows so that it fits
beside nothing else on the card. It imports nothing of the program: it is
handed the rows the benchmark made (the corpus, the stream's writes) and
the time (a step number) at which each row was live, and nothing that the
program built.

A row ``r`` is live for a query asked at step ``s`` when
``start[r] <= s < end[r]``: a corpus row from step -1 until its id is
first overwritten or deleted, a written row from the step of its write
until the next write or delete of its id. A read-only cell passes no
times: every row is live.

``tf32=True`` computes the same thing one precision lower (TF32 matmuls
on the card, operands rounded to TF32 on the CPU): the control, which the
comparison must refuse.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

INF = float("inf")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    to even), as the tensor cores read them."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _precision(tf32: bool):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _block_d2(q: torch.Tensor, qn: torch.Tensor, x: torch.Tensor,
              tf32: bool) -> torch.Tensor:
    """(Q, B) squared distances by ||q||^2 - 2 q.x + ||x||^2."""
    if tf32 and x.device.type != "cuda":
        d2 = round_tf32(q) @ round_tf32(x).T
    else:
        with _precision(tf32):
            d2 = q @ x.T
    d2.mul_(-2.0).add_(qn[:, None]).add_((x * x).sum(dim=1)[None, :])
    return d2


def knn(queries: torch.Tensor, parts: Sequence[torch.Tensor], k: int, *,
        step: Optional[torch.Tensor] = None,
        start: Optional[torch.Tensor] = None,
        end: Optional[torch.Tensor] = None, block: int = 1 << 18,
        tf32: bool = False):
    """The exact ``k`` nearest live rows of each query.

    ``parts`` are row blocks of one row space, indexed in order (the
    corpus, then the writes); ``step`` (Q,) the step at which each query
    was asked and ``start`` / ``end`` (R,) each row's live interval, or
    all three None. Returns (d2 (Q, k) ascending, row (Q, k) int64, -1
    where fewer than ``k`` rows are live)."""
    nq = queries.shape[0]
    dev = queries.device
    q = queries.to(torch.float32)
    qn = (q * q).sum(dim=1)
    best_d = torch.full((nq, k), INF, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    off = 0
    for part in parts:
        for s in range(0, part.shape[0], block):
            x = part[s:s + block].to(dev, torch.float32)
            d2 = _block_d2(q, qn, x, tf32)
            if step is not None:
                st = start[off + s:off + s + x.shape[0]].to(dev)
                en = end[off + s:off + s + x.shape[0]].to(dev)
                live = ((st[None, :] <= step[:, None])
                        & (step[:, None] < en[None, :]))
                d2.masked_fill_(~live, INF)
            kk = min(k, x.shape[0])
            v, i = torch.topk(d2, kk, dim=1, largest=False)
            del d2
            i = torch.where(torch.isinf(v), -1, i + off + s)
            v, sel = torch.topk(torch.cat([best_d, v], dim=1), k, dim=1,
                                largest=False)
            best_i = torch.gather(torch.cat([best_i, i], dim=1), 1, sel)
            best_d = v
        off += part.shape[0]
    return best_d, best_i


def gather_rows(parts: Sequence[torch.Tensor], rows: torch.Tensor
                ) -> torch.Tensor:
    """Rows of the space that ``parts`` index, by global row number (any
    shape of ``rows``; -1 gives a row of NaN)."""
    flat = rows.reshape(-1)
    out = torch.full((flat.shape[0], parts[0].shape[1]), float("nan"),
                     dtype=torch.float32, device=flat.device)
    off = 0
    for part in parts:
        hit = (flat >= off) & (flat < off + part.shape[0])
        idx = hit.nonzero()[:, 0]
        if idx.numel():
            out[idx] = part[(flat[idx] - off).to(part.device)].to(
                flat.device, torch.float32)
        off += part.shape[0]
    return out.reshape(tuple(rows.shape) + (parts[0].shape[1],))


def true_dist(queries: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """Distance of each query to each of its rows, (Q, k) from (Q, D) and
    (Q, k, D), by the difference form in float64 (NaN rows give NaN)."""
    diff = vectors.double() - queries.double()[:, None, :]
    return (diff * diff).sum(dim=-1).sqrt()
