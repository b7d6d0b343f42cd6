"""Dry-run of the paper's core at production scale: one distributed-MPAD
iteration (``core.distributed.make_phi_dist``) traced on rank r of the
2 x 16 x 16 fake world, N = 2^20 corpus rows x 1024 dims, the rows split
over every axis (port of ``repro.launch.dryrun_mpad``).

It shows the communication design of ``core.distributed``: an iteration
moves O(N) scalar bytes (the all-gather of the projections) and an O(n)
gradient all-reduce, against O(N · n) for a naive exchange of the rows.
The numbers are rank r's (``launch.step_analysis``): its FLOPs, unfused
bytes, collective operand bytes and calls by kind, and its peak of live
storage; on the 512-rank mesh a rank's all-gather operand is its 2,048
projections (8,192 B) and its all-reduce the 1,024-gradient (4,096 B).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_mpad \\
      [--n 1048576 --dim 1024 --m 128] [--ranks R] [--rank r]

``--ranks R`` traces a 1-D world of R ranks over "data" in place of the
production mesh. ``--device`` is ``launch.dryrun``'s (``cuda`` or ``meta``,
both the card).
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.distributed import make_phi_dist
from repro_torch.launch.dryrun import DEFAULT_OUT, default_device
from repro_torch.launch.mesh import fake_world, production_shape
from repro_torch.launch.step_analysis import analyze_step

__all__ = ["phi_args", "phi_step", "trace", "main"]

B, ALPHA = 80.0, 25.0


def phi_args(n: int, dim: int, m: int, n_ranks: int, device,
             dtype=torch.float32):
    """Uninitialised (w (dim,), this rank's rows (n / n_ranks, dim), the
    previous directions (m, dim), their mask (m,)): fake tensors under an
    active ``FakeTensorMode``."""
    if n % n_ranks:
        raise ValueError(f"N={n} is not a multiple of {n_ranks} ranks")
    return (torch.empty((dim,), dtype=dtype, device=device),
            torch.empty((n // n_ranks, dim), dtype=dtype, device=device),
            torch.empty((m, dim), dtype=dtype, device=device),
            torch.empty((m,), dtype=dtype, device=device))


def phi_step(mesh, n: int):
    """One iteration's rank program: ``make_phi_dist(mesh, n)`` at b 80,
    alpha 25 (JAX's dry-run's)."""
    phi = make_phi_dist(mesh, n)
    return lambda w, x_loc, prev, mask: phi(w, x_loc, prev, mask, b=B,
                                            alpha=ALPHA)


def trace(n: int, dim: int, m: int, mesh_shape: Sequence[int],
          axes: Tuple[str, ...], rank: int = 0,
          device: Optional[str] = None) -> dict:
    """Rank ``rank``'s record of one iteration on a fake world of
    ``mesh_shape`` over ``axes`` (JAX's record keys)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    device = device or default_device()
    n_ranks = math.prod(mesh_shape)
    with fake_world(mesh_shape, axes, rank, device) as mesh, \
            FakeTensorMode(allow_non_fake_inputs=True):
        res = analyze_step(phi_step(mesh, n),
                           phi_args(n, dim, m, n_ranks, device), mesh)
    naive = n * dim * 4                  # the rows exchanged once, f32
    tag = "x".join(map(str, mesh_shape))
    return {
        "cell": f"mesh_{tag}.mpad-core.fit_iteration",
        "n": n, "dim": dim, "m": m, "n_devices": n_ranks, "rank": rank,
        "device": device,
        "dot_flops_dev": res["dot_flops"],
        "bytes_dev": res["bytes"],
        "coll_bytes_dev": res["coll_total"],
        "coll_bytes_by_kind": {k[5:]: v for k, v in res.items()
                               if k.startswith("coll_") and
                               k not in ("coll_total", "coll_counts")},
        "coll_counts": res["coll_counts"],
        "peak_mem_dev": res["peak_bytes"],
        "argument_bytes_dev": res["argument_bytes"],
        "naive_exchange_bytes": naive,
        "comm_reduction_vs_naive": naive / max(res["coll_total"], 1),
        "trace_s": res["seconds"],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--ranks", type=int, default=None,
                    help="a 1-D world of this many ranks in place of the "
                         "2 x 16 x 16 production mesh")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=os.path.join(DEFAULT_OUT,
                                                  "mpad_core.json"))
    args = ap.parse_args(argv)
    if args.ranks:
        shape, axes = (args.ranks,), ("data",)
    else:
        shape, axes = production_shape(multi_pod=True)
    rec = trace(args.n, args.dim, args.m, shape, axes, args.rank,
                args.device)
    print(json.dumps(rec, indent=1))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"\nper-rank collective bytes/iteration: "
          f"{rec['coll_bytes_dev']:.3e} (all-gather of N/P scalars + "
          f"all-reduce of the n-gradient)\nnaive X-exchange would be "
          f"{rec['naive_exchange_bytes']:.3e} B "
          f"({rec['comm_reduction_vs_naive']:.0f}x more)")
    return rec


if __name__ == "__main__":
    main()
