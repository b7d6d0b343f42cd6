"""GIN's neighbour sum on the card in a fixed order (a port-only kernel:
the JAX package has no Pallas kernel for it; see ``csrc/csr_gather_sum.cu``
for why the card needs one).

``build_csr`` sorts a graph's edges once, stably, by destination (the
forward's order) and by source (the backward's), into a ``GraphCSR``.
``csr_gather_sum`` is the kernel's wrapper: for a CUDA tensor it launches
the kernel or raises (f32 only; no fallback to ``index_add_``), for a CPU
tensor it takes its plain version ``csr_gather_sum_plain``. Each launch
adds one to ``csr_gather_sum.launches`` and to the order's entry of
``csr_gather_sum.launches_by_order`` ("dst" forward, "src" backward).
``gin_aggregate`` is the ``autograd.Function``: the kernel on the
destination order forward, the same kernel on the source order applied to
the incoming gradient backward (no gradient for the mask). On the CPU it
runs ``ref.gather_sum_ref`` on the edge lists, which adds in edge order,
as JAX's ``segment_sum`` and its gradient do there.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .build import library
from .ref import gather_sum_ref

__all__ = ["CSROrder", "GraphCSR", "build_csr", "csr_gather_sum",
           "csr_gather_sum_plain", "gin_aggregate"]

_INT_MAX = 2 ** 31 - 1


class CSROrder(NamedTuple):
    """One order of a graph's edges: the rows are one endpoint ("dst" or
    "src"), each row's edges in their original order."""
    by: str
    rowptr: torch.Tensor      # (n_rows + 1,) int32 offsets into col / w
    col: torch.Tensor         # (E,) int32: the edge's other endpoint
    w: torch.Tensor           # (E,) f32: the edge's mask
    rows: torch.Tensor        # (n_rows,) int32 launch order, longest first

    @property
    def n_rows(self) -> int:
        return self.rowptr.shape[0] - 1


class GraphCSR(NamedTuple):
    """A graph prepared for ``gin_aggregate``: the edge lists as given
    (the CPU route's) and both sorted orders (the card's)."""
    src: torch.Tensor
    dst: torch.Tensor
    mask: torch.Tensor        # (E,) f32
    n_dst: int
    n_src: int
    fwd: CSROrder             # by destination: the forward
    bwd: CSROrder             # by source: the backward


def _order(by: str, key: torch.Tensor, other: torch.Tensor,
           mask: torch.Tensor, n_rows: int) -> CSROrder:
    perm = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_rows)
    rowptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=key.device)
    torch.cumsum(counts, 0, out=rowptr[1:])
    rows = torch.argsort(counts, descending=True, stable=True)
    return CSROrder(by, rowptr.int(), other[perm].int(), mask[perm],
                    rows.int())


def build_csr(src: torch.Tensor, dst: torch.Tensor,
              mask: Optional[torch.Tensor], n_dst: int,
              n_src: Optional[int] = None) -> GraphCSR:
    """Both orders of the edges (src[e], dst[e]) with weights ``mask``
    (None: ones), cast to f32 as JAX casts the mask to the messages'
    dtype; sources in [0, n_src) (default n_dst), destinations in
    [0, n_dst). Each order is a stable sort, so a row keeps its edges in
    edge order. Run once per graph, on the graph's device (one host sync
    checks the ids)."""
    n_src = n_dst if n_src is None else n_src
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst "
                         f"{tuple(dst.shape)} must be one (E,) pair")
    e = src.shape[0]
    if max(e, n_dst, n_src) > _INT_MAX:
        raise ValueError(f"E={e}, n_dst={n_dst}, n_src={n_src}: int32 "
                         "indices only")
    if mask is None:
        mask = torch.ones(e, dtype=torch.float32, device=src.device)
    if mask.shape != src.shape or mask.device != src.device \
            or dst.device != src.device:
        raise ValueError("src, dst and mask must be (E,) on one device")
    mask = mask.to(torch.float32)
    src, dst = src.long(), dst.long()
    if e and not (0 <= int(src.min()) and int(src.max()) < n_src
                  and 0 <= int(dst.min()) and int(dst.max()) < n_dst):
        raise ValueError("an edge endpoint is out of range")
    return GraphCSR(src, dst, mask, n_dst, n_src,
                    _order("dst", dst, src, mask, n_dst),
                    _order("src", src, dst, mask, n_src))


def csr_gather_sum_plain(x: torch.Tensor, order: CSROrder) -> torch.Tensor:
    """The kernel's plain version: ``ref.gather_sum_ref`` over the order's
    edges (row r's edges in stored order), out (n_rows, F). On the CPU it
    adds in that order, so its bits are the kernel's; any device."""
    counts = (order.rowptr[1:] - order.rowptr[:-1]).long()
    row_of_edge = torch.repeat_interleave(
        torch.arange(order.n_rows, device=x.device), counts)
    return gather_sum_ref(x, order.col, row_of_edge, order.w, order.n_rows)


def _check(x: torch.Tensor, order: CSROrder):
    if x.ndim != 2:
        raise ValueError(f"x must be (n, F), got {tuple(x.shape)}")
    for name in ("rowptr", "col", "w", "rows"):
        t = getattr(order, name)
        if t.device != x.device:
            raise ValueError(f"order.{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"order.{name} must be contiguous")
    if order.col.shape != order.w.shape or \
            order.rows.shape[0] != order.n_rows:
        raise ValueError("the order's arrays do not fit one another")


def csr_gather_sum(x: torch.Tensor, order: CSROrder) -> torch.Tensor:
    """out (order.n_rows, F): out[r] = sum of w[e] * x[col[e]] over row r's
    edges, in stored order, from +0.0, each term rounded then added
    (rows with no edges give 0). x (n, F) f32, contiguous; every col < n.
    CPU tensors take ``csr_gather_sum_plain``; CUDA tensors launch the
    kernel (bit-equal to it)."""
    _check(x, order)
    if x.device.type == "cpu":
        return csr_gather_sum_plain(x, order)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.float32 or order.w.dtype != torch.float32:
        raise TypeError(f"the kernel takes f32 x and w, got {x.dtype} and "
                        f"{order.w.dtype}")
    if any(getattr(order, n).dtype != torch.int32
           for n in ("rowptr", "col", "rows")):
        raise TypeError("rowptr, col and rows must be int32")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n_rows, f = order.n_rows, x.shape[1]
    out = torch.empty((n_rows, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    vec = 4 if f % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = library().qpad_csr_gather_sum(
            x.data_ptr(), order.rowptr.data_ptr(), order.col.data_ptr(),
            order.w.data_ptr(), order.rows.data_ptr(), n_rows, f, vec,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"csr_gather_sum launch failed: CUDA error {err}")
    csr_gather_sum.launches += 1
    csr_gather_sum.launches_by_order[order.by] += 1
    return out


csr_gather_sum.launches = 0
csr_gather_sum.launches_by_order = {"dst": 0, "src": 0}


class _GinAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, csr):
        ctx.csr = csr
        if h.device.type == "cpu":
            return gather_sum_ref(h, csr.src, csr.dst, csr.mask, csr.n_dst)
        return csr_gather_sum(h, csr.fwd)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        csr = ctx.csr
        g = g.contiguous()
        if g.device.type == "cpu":
            return gather_sum_ref(g, csr.dst, csr.src, csr.mask,
                                  csr.n_src), None
        return csr_gather_sum(g, csr.bwd), None


def gin_aggregate(h: torch.Tensor, csr: GraphCSR) -> torch.Tensor:
    """JAX's ``segment_sum(h[edge_src] * edge_mask[:, None], edge_dst,
    num_segments=n_dst)`` over ``csr``'s edges (h (n_src, F)), with its
    gradient in ``h``: bit-equal to JAX on the CPU, the fixed-order kernel
    on the card."""
    if h.shape[0] != csr.n_src:
        raise ValueError(f"h has {h.shape[0]} rows, the graph {csr.n_src} "
                         "sources")
    return _GinAggregate.apply(h, csr)
