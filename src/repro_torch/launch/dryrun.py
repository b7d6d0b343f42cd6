"""Dry-run of the production meshes: trace one rank's program of every
(arch x shape x mesh) cell at full size, on fake tensors (port of
``repro.launch.dryrun``).

JAX's dry-run lowers and compiles each cell's global step for 256 or 512
forced host devices and reads XLA's analyses. Torch has no compiler to
ask; the port traces the rank program instead. For each cell this driver:

  1. joins a fake world of 256 (16 x 16) or 512 (2 x 16 x 16) ranks in
     this one process as rank ``--rank`` (``launch.mesh.fake_world``:
     torch's fake process group, the same per-axis groups as a real mesh);
  2. makes the cell's global arguments as fake tensors
     (``ArchSpec.abstract_args``: no allocation) and cuts this rank's
     blocks under ``ArchSpec.arg_specs`` (``parallel.sharding.shard_tree``);
  3. traces one call of the rank program (``ArchSpec.step_fn``) under
     ``launch.step_analysis.analyze_step``: FLOPs (``FlopCounterMode``,
     the kernels' custom ops by their formulas), the unfused bytes, the
     collective bytes and calls by kind (``context.count_collectives``),
     the peak of live storage, and K5's, K6's and the aggregate's launches;
  4. writes one JSON record a cell to ``--out`` (finished cells are
     skipped on a re-run), with JAX's keys where they mean the same
     thing. JAX's ``hlo_*`` keys re-count XLA's ``cost_analysis()`` through
     loop trip counts; a trace counts every trip once, so ``flops``,
     ``bytes_accessed`` and ``collectives`` are both, and the one detail
     left is ``step_bytes_top``, the aten ops that move the most bytes.

``--device`` is where the fake tensors say they live: ``cuda`` (a fake
tensor needs no card), or ``meta``; both model the card, since the kernels'
wrappers take the card's route for a CUDA or a meta tensor (the launches'
fake implementations give the shapes and count the launch). A torch built
without CUDA cannot run autograd's backward on tensors that claim a CUDA
device (the engine's device thread needs the CUDA runtime), so there the
default is ``meta``; the two give the same numbers.

Statuses: ``ok``; ``skipped`` (JAX's documented skips); ``error``. The
exit code is 1 on any ``error``.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
      [--arch NAME] [--shape NAME] [--out build/dryrun] [--rank R]

A cut of an LM cell (``--shape train_4k --mesh-shape 2x2 --batch 4
--seq 1024 --layers 6 --capacity-factor 4.0``; any of the four LM shapes)
traces that configuration on a ("data", "model") mesh of the given shape:
the dry-run of a run the card can make (``chip_smoke.py`` paths 15 and
16).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.configs import all_arch_names, get_arch
from repro_torch.configs.common import ArchSpec
from repro_torch.launch.mesh import fake_world, production_shape
from repro_torch.launch.step_analysis import analyze_step, bytes_breakdown
from repro_torch.parallel.context import COLLECTIVE_KINDS

__all__ = ["run_cell", "cut_arch", "default_device", "main", "DEFAULT_OUT"]

DEFAULT_OUT = os.path.join("build", "dryrun")


def default_device() -> str:
    """``cuda`` where torch is built with CUDA, else ``meta`` (the module
    docstring): both model the card."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


def cut_arch(name: str, batch: Optional[int] = None,
             seq: Optional[int] = None, layers: Optional[int] = None,
             capacity_factor: Optional[float] = None,
             shape: str = "train_4k") -> ArchSpec:
    """LM arch ``name`` with its ``shape`` cell (default ``train_4k``) cut:
    the batch and sequence, the depth, the MoE capacity factor (each None:
    the published value). The cut arch has that one cell, never skipped
    (a cut ``long_500k`` of a full-attention arch is a run a card can
    make)."""
    from repro_torch.configs import lm_family
    from repro_torch.configs.registry import config_module
    mod = config_module(name)
    if not hasattr(mod, "SMOKE"):
        raise ValueError(f"a cut applies to an LM arch, not {name!r}")
    cfg = mod.CONFIG
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if capacity_factor is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    cell = dict(lm_family.LM_SHAPES[shape])
    cell.update({k: v for k, v in (("batch", batch), ("seq", seq))
                 if v is not None})
    return lm_family.make_lm_arch(name, cfg, mod.SMOKE, long_ok=True,
                                  shapes={shape: cell})


def _mesh_tag(shape: Tuple[int, ...]) -> str:
    if shape == (16, 16):
        return "pod_16x16"
    if shape == (2, 16, 16):
        return "multipod_2x16x16"
    return "mesh_" + "x".join(map(str, shape))


def _axes(shape: Tuple[int, ...]) -> Tuple[str, ...]:
    return (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))


def run_cell(arch_name: str, shape_name: str,
             mesh_shape: Sequence[int], out_dir: Optional[str],
             rank: int = 0, device: Optional[str] = None,
             arch: Optional[ArchSpec] = None, tag: str = "",
             verbose: bool = True) -> dict:
    """One cell's record (the module docstring), written to ``out_dir``
    unless None. ``arch`` (default ``get_arch(arch_name)``) may be a
    ``cut_arch``; ``tag`` then names the cut in the cell id."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.parallel.sharding import shard_tree
    mesh_shape = tuple(int(n) for n in mesh_shape)
    device = device or default_device()
    mesh_tag = _mesh_tag(mesh_shape)
    cell_id = f"{mesh_tag}.{arch_name}{tag}.{shape_name}"
    path = None if out_dir is None else os.path.join(out_dir,
                                                     cell_id + ".json")
    if path is not None and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") in ("ok", "skipped"):
            if verbose:
                print(f"[cached] {cell_id}: {rec['status']}")
            return rec
    arch = arch or get_arch(arch_name)
    sdef = arch.shapes[shape_name]
    rec = {"cell": cell_id, "arch": arch_name, "shape": shape_name,
           "mesh": mesh_tag, "mesh_shape": list(mesh_shape),
           "kind": sdef.kind, "n_devices": math.prod(mesh_shape),
           "rank": rank, "device": device,
           "model_flops": arch.model_flops(shape_name)}
    if sdef.skip is not None:
        rec.update(status="skipped", reason=sdef.skip)
        _write(path, rec)
        if verbose:
            print(f"[skip]   {cell_id}: {sdef.skip}")
        return rec
    t0 = time.perf_counter()
    try:
        with fake_world(mesh_shape, _axes(mesh_shape), rank, device) as mesh, \
                FakeTensorMode(allow_non_fake_inputs=True):
            args = arch.abstract_args(shape_name, device)
            blocks = shard_tree(mesh, args, arch.arg_specs(shape_name, mesh))
            del args
            step = arch.step_fn(shape_name, mesh)
            res = analyze_step(step, blocks, mesh)
            del blocks, res["out"]
        coll = {k: res[f"coll_{k}"] for k in COLLECTIVE_KINDS}
        coll.update(total=res["coll_total"], counts=res["coll_counts"])
        rec.update(
            status="ok", trace_s=round(time.perf_counter() - t0, 2),
            flops=res["dot_flops"], bytes_accessed=res["bytes"],
            memory={"argument_size_in_bytes": res["argument_bytes"],
                    "output_size_in_bytes": res["output_bytes"],
                    "alias_size_in_bytes": res["alias_bytes"],
                    "temp_size_in_bytes": res["peak_bytes"]
                    - res["argument_bytes"],
                    "peak_memory_in_bytes": res["peak_bytes"]},
            collectives=coll, step_bytes_top=bytes_breakdown(res),
            launches=res["launches"])
        if verbose:
            print(f"[ok]     {cell_id}: trace {rec['trace_s']:.1f}s "
                  f"flops={res['dot_flops']:.3e} "
                  f"args={res['argument_bytes'] / 1e9:.3f}GB "
                  f"peak={res['peak_bytes'] / 1e9:.3f}GB "
                  f"coll={res['coll_total']:.3e}B")
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[FAIL]   {cell_id}: {type(e).__name__}: {e}")
    _write(path, rec)
    return rec


def _write(path, rec):
    if path is None:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--mesh-shape", default=None,
                    help="a ('data', 'model') mesh such as 2x2 in place of "
                         "the production meshes")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda or meta (default: cuda where torch is built "
                         "with CUDA, else meta)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    args = ap.parse_args(argv)
    device = args.device or default_device()
    if device not in ("cuda", "meta"):
        raise SystemExit(f"--device {device}: the dry-run models the card "
                         "(cuda or meta)")
    if device == "cuda" and not torch.backends.cuda.is_built():
        raise SystemExit("--device cuda needs a torch built with CUDA (the "
                         "backward's device thread); use --device meta")
    archs = [args.arch] if args.arch else all_arch_names()
    if args.mesh_shape:
        meshes = [tuple(int(n) for n in args.mesh_shape.split("x"))]
    else:
        meshes = [production_shape(m)[0] for m in
                  {"single": [False], "multi": [True],
                   "both": [False, True]}[args.mesh]]
    cut = {k: v for k, v in (("batch", args.batch), ("seq", args.seq),
                             ("layers", args.layers),
                             ("capacity_factor", args.capacity_factor))
           if v is not None}
    if cut and args.shape is None:
        raise SystemExit("a cut (--batch, --seq, --layers, "
                         "--capacity-factor) names its cell: --shape")
    failed = []
    t0 = time.perf_counter()
    for shape in meshes:
        for a in archs:
            arch = cut_arch(a, shape=args.shape, **cut) if cut \
                else get_arch(a)
            tag = ("@" + ",".join(f"{k}={v}" for k, v in cut.items())
                   if cut else "")
            shapes = [args.shape] if args.shape else list(arch.shapes)
            for s in shapes:
                rec = run_cell(a, s, shape, args.out, args.rank, device,
                               arch=arch, tag=tag)
                if rec["status"] == "error":
                    failed.append(rec["cell"])
    print(f"\ndone in {time.perf_counter() - t0:.1f} s. "
          f"{'FAILURES: ' + ', '.join(failed) if failed else 'no error.'}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
