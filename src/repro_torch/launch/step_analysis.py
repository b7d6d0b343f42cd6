"""What one call of a rank's program costs (the counterpart of
``repro.launch.hlo_analysis``): FLOPs, bytes, collectives, peak memory and
kernel launches, read from one traced call.

``analyze_step(fn, args, mesh)`` runs ``fn(*args)`` once, on real tensors
or, in the dry-run, on fake ones (``FakeTensorMode``: shapes and dtypes,
no memory, no numbers), and returns JAX's keys:

  * ``dot_flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total:
    the aten products (``mm``, ``bmm``, ``addmm``, ..., and ``mv`` and
    ``dot``, whose formulas this module adds) and the custom ops of the
    port's kernels by their FLOP formulas (K5, K6, the aggregate);
  * ``bytes``: every aten op's input and output bytes, each op charged as
    a kernel of its own, with views and metadata ops at zero
    (``_zero_cost``: JAX's ``_ZERO_COST_OPS``). Eager PyTorch launches each
    op as its own kernel, so this is the unfused traffic; XLA's fusion,
    which ``hlo_analysis`` charges once a fused kernel, has no counterpart;
  * ``coll_<kind>`` for JAX's five kinds (``context.COLLECTIVE_KINDS``),
    ``coll_total`` and ``coll_counts``: the operand bytes and calls that
    ``parallel.context.count_collectives`` records in the mesh's
    collective wrappers, the same counter a real run reads;

and beside them ``argument_bytes`` (the distinct storages of ``args``),
``output_bytes`` and ``alias_bytes`` (the output's storages, and those of
them that are arguments' storages: an in-place update), ``peak_bytes``
(the high-water mark of the live storages' bytes over the call, arguments
included: ``_Trace``) and ``launches`` (K5's, K6's and the
aggregate's, by route and order).

``peak_bytes`` takes the place of XLA's ``memory_analysis()``: a storage
is live from the op that makes it until its last reference goes (autograd's
saved tensors included), on the card rounded up to the caching allocator's
512-byte blocks. What it cannot see: the allocator's fragmentation (the
``max_memory_allocated`` it predicts counts allocated blocks only),
cuBLAS's workspace and the kernels' own scratch buffers, which the
launches' fake implementations do not make. XLA's ``temp_size_in_bytes``
is ``peak_bytes - argument_bytes`` here.

Loops run in Python, so every trip of a loop is traced and counted: no
trip-count logic (``hlo_analysis``'s ``known_trip_count``) is needed.
"""
from __future__ import annotations

import time
import weakref
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import (FlopCounterMode, flop_registry,
                                      register_flop_formula)
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch._device import CARD_DEVICE_TYPES
from repro_torch.parallel.context import COLLECTIVE_KINDS, count_collectives

__all__ = ["analyze_step", "bytes_breakdown", "tensor_bytes",
           "kernel_launches", "ALLOC_BLOCK"]

ALLOC_BLOCK = 512               # the CUDA caching allocator's rounding

_aten = torch.ops.aten
# ops that move no bytes: they allocate, alias or read metadata
_ZERO_COST = {_aten.empty, _aten.empty_like, _aten.empty_strided,
              _aten.new_empty, _aten.new_empty_strided, _aten.detach,
              _aten.lift_fresh, _aten.alias, _aten.sym_size,
              _aten.sym_stride, _aten.sym_numel, _aten.sym_storage_offset,
              _aten._local_scalar_dense, _aten.is_same_size}


def _mv_flops(a_shape, x_shape, *args, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _dot_flops(a_shape, b_shape, *args, **kwargs) -> int:
    return 2 * a_shape[0]


def _count_matvec_flops():
    """FlopCounterMode counts matrix products but no matrix-vector product
    or dot (JAX's dot_flops counts every dot): register their formulas,
    where this torch has none (once a process)."""
    for op, formula in ((_aten.mv, _mv_flops), (_aten.dot, _dot_flops)):
        if op not in flop_registry:
            register_flop_formula(op)(formula)


def _zero_cost(func) -> bool:
    return func.is_view or func.overloadpacket in _ZERO_COST


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def tensor_bytes(tree: Any) -> int:
    """The bytes of the distinct storages the tensors of ``tree`` hold."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def _rounded(nbytes: int, device: torch.device) -> int:
    if device.type in CARD_DEVICE_TYPES:
        return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK
    return nbytes


class _Trace(TorchDispatchMode):
    """One pass over the call's ops for two readings: each aten op's input
    and output bytes (a kernel's reads and writes, unfused), by op, views
    and metadata ops at zero and collectives (``c10d``) left to
    ``count_collectives``; and the live storages' bytes, each storage
    counted from the op that makes it until it is freed (a weak
    reference's callback), ``peak`` their high-water mark."""

    def __init__(self, args: Any):
        super().__init__()
        self.by_op: Dict[str, int] = {}
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in _tensors(args):
            self._track(t)

    def _free(self, nbytes: int):
        self.live -= nbytes

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = _rounded(st.nbytes(), t.device)
        self._seen[st] = weakref.ref(st, lambda _, n=n: self._free(n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        ns = func.namespace
        if ns in ("aten", "repro_torch") and not _zero_cost(func):
            n = sum(t.numel() * t.element_size()
                    for t in _tensors((args, kwargs)) + outs)
            key = f"{ns}.{func.overloadpacket.__name__}"
            self.by_op[key] = self.by_op.get(key, 0) + n
        return out


def kernel_launches() -> Dict[str, Any]:
    """The port's kernel counters that a dry-run path can reach: K5's and
    K6's launches by route, the aggregate's by order."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ce as fce
    from repro_torch.kernels import graph_agg as ga
    return {
        "flash_attention_fwd": fa.flash_attention_fwd.launches,
        "fused_ce_fwd": fce.fused_ce_fwd.launches,
        "csr_gather_sum": ga.csr_gather_sum.launches,
        "flash_attention_fwd_by_route": dict(
            fa.flash_attention_fwd.launches_by_route),
        "fused_ce_fwd_by_route": dict(fce.fused_ce_fwd.launches_by_route),
        "csr_gather_sum_by_order": dict(
            ga.csr_gather_sum.launches_by_order)}


def _launch_delta(before: Dict[str, Any], after: Dict[str, Any]):
    out = {}
    for k, v in after.items():
        out[k] = ({r: n - before[k][r] for r, n in v.items()}
                  if isinstance(v, dict) else v - before[k])
    return out


def analyze_step(fn: Callable, args: Sequence[Any], mesh=None) -> dict:
    """One call ``fn(*args)`` traced (the module docstring's keys), plus
    ``out`` (its return value), ``n_ranks`` (``mesh.size``, 1 without a
    mesh), ``bytes_by_op`` and ``seconds`` (the call's wall time)."""
    _count_matvec_flops()
    args = tuple(args)
    arg_storages = {t.untyped_storage()._cdata for t in _tensors(args)}
    before = kernel_launches()
    trace = _Trace(args)
    t0 = time.perf_counter()
    with count_collectives() as coll, FlopCounterMode(display=False) as fc, \
            trace:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    outs = _tensors(out)
    res = {
        "dot_flops": float(fc.get_total_flops()),
        "bytes": float(sum(trace.by_op.values())),
        **{f"coll_{k}": float(coll.bytes[k]) for k in COLLECTIVE_KINDS},
        "coll_total": float(coll.total),
        "coll_counts": dict(coll.calls),
        "argument_bytes": tensor_bytes(args),
        "output_bytes": tensor_bytes(out),
        "alias_bytes": tensor_bytes([
            t for t in outs if t.untyped_storage()._cdata in arg_storages]),
        "peak_bytes": trace.peak,
        "launches": _launch_delta(before, kernel_launches()),
        "bytes_by_op": dict(trace.by_op),
        "n_ranks": 1 if mesh is None else mesh.size,
        "seconds": seconds,
        "out": out,
    }
    return res


def bytes_breakdown(result: dict, top: int = 12) -> List[Tuple[str, int]]:
    """The ``top`` aten ops that move the most bytes in an
    ``analyze_step`` result: which ops make the memory term."""
    return sorted(result["bytes_by_op"].items(), key=lambda kv: -kv[1])[:top]
