"""Serving mesh construction (port of ``repro.launch.mesh``, the serving
part).

``make_serving_mesh`` joins (or starts) the default ``torch.distributed``
process group and returns this process's ``Mesh`` record. Under torchrun
the world comes from ``WORLD_SIZE`` / ``RANK`` (and ``MASTER_ADDR`` /
``MASTER_PORT``); a lone process with no such variables is a world of one.
``run_ranks`` starts ``shards`` processes on 127.0.0.1 itself, each of
which builds its mesh and runs a function, for a caller that is not under
torchrun (the serving launcher, the tests); they meet through a file
store.

``backend="nccl"`` is one rank a card and refuses more shards than cards;
``backend="gloo"`` (the launcher's ``--mesh host``) puts every rank on the
caller's device: CPU tensors, or several ranks on one card.
"""
from __future__ import annotations

import os
import pickle
import socket
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.parallel.context import BACKENDS, Mesh

__all__ = ["make_serving_mesh", "run_ranks", "rank_threads", "free_port"]


def make_serving_mesh(shards: Optional[int] = None, axis: str = "data",
                      backend: str = "nccl", device: DeviceLike = None,
                      init_method: Optional[str] = None) -> Mesh:
    """1-D data-parallel serving mesh of ``shards`` ranks (default: the
    world's size) under ``axis``; returns this process's ``Mesh``.

    Joins the default process group when one is initialized, else starts
    it at ``init_method`` when given, else from torchrun's environment
    where set, else as a world of one on 127.0.0.1. Under ``"nccl"`` rank r serves from ``cuda:LOCAL_RANK``
    (r without torchrun) and more shards than cards is an error; under
    ``"gloo"`` every rank serves from ``device`` (default: CUDA, which must
    be present, unless the caller names the CPU).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    if shards is None:
        shards = world
    if shards < 1:
        raise ValueError("shards must be >= 1")
    if shards != world:
        raise RuntimeError(
            f"need {shards} ranks for a serving mesh, the world has {world}: "
            "start one process a shard (torchrun --nproc-per-node "
            f"{shards}, or repro_torch.launch.mesh.run_ranks)")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if shards > cards:
            raise RuntimeError(
                f"need {shards} CUDA devices for an NCCL serving mesh (one "
                f"rank a card), have {cards}: use backend='gloo' (the "
                "launcher's --mesh host) to put several ranks on one device")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    if not dist.is_initialized():
        if init_method is not None:
            init = init_method
        elif "MASTER_ADDR" in os.environ:
            init = "env://"
        else:
            init = f"tcp://127.0.0.1:{free_port()}"
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank)
    elif dist.get_backend() != backend:
        raise RuntimeError(
            f"the default process group runs {dist.get_backend()!r}, not "
            f"{backend!r}")
    return Mesh(axis=axis, size=shards, rank=rank,
                group=dist.group.WORLD, backend=backend, device=dev)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_threads(world: int) -> int:
    """The CPU threads each of ``world`` ranks on one host takes: an equal
    share of half the host's cores (a rank's thread pool that claims them
    all thrashes against the others'; the other half stays with the
    parent and the collectives' threads)."""
    return max(1, (os.cpu_count() or 1) // (2 * world))


def _rank_main(rank: int, world: int, store: str, backend: str, device,
               axis: str, job: str, queue):
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(rank_threads(world))
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        mesh = make_serving_mesh(world, axis=axis, backend=backend,
                                 device=device, init_method=f"file://{store}")
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out if rank == 0 else None))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, shards: int, args: Sequence[Any] = (), *,
              backend: str = "gloo", device: DeviceLike = None,
              axis: str = "data", timeout: float = 600.0):
    """Run ``fn(mesh, *args)`` in ``shards`` new processes, one a rank of
    a serving mesh on 127.0.0.1, each with ``rank_threads(shards)`` CPU
    threads, and return rank 0's return value (which must pickle; return
    host data). ``fn`` must be importable by name (a
    module-level function). A rank that raises, or dies, fails the call
    with the rank's traceback; every process is joined (or killed past
    ``timeout`` seconds) before this returns or raises. The ranks meet
    through a file store in a fresh temporary directory (no TCP port to
    collide with another launch's), and read ``fn`` and ``args`` from a
    file there: a process's start arguments go through a pipe that blocks
    the next start until the child has read them, after its imports."""
    import multiprocessing as mp
    import queue as queue_mod
    import shutil
    import tempfile
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="qpad-ranks-")
    store = os.path.join(store_dir, "store")
    job = os.path.join(store_dir, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    dev = None if device is None else str(device)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, shards, store, backend, dev, axis, job, q),
                         daemon=True)
             for r in range(shards)]
    for p in procs:
        p.start()
    result, errors, reported = None, [], set()
    deadline = time.monotonic() + timeout
    try:
        while len(reported) < shards:
            try:
                rank, ok, payload = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in reported and p.exitcode is not None]
                if dead:
                    errors.append(f"rank {dead[0]} exited with code "
                                  f"{procs[dead[0]].exitcode} and no report")
                    break
                if time.monotonic() > deadline:
                    errors.append(f"ranks {sorted(set(range(shards)) - reported)}"
                                  f" still running after {timeout} s")
                    break
                continue
            reported.add(rank)
            if not ok:
                errors.append(f"rank {rank} failed:\n{payload}")
                break
            if rank == 0:
                result = payload
    finally:
        for p in procs:
            p.join(timeout=0 if errors else max(1.0, deadline -
                                                time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    if errors:
        raise RuntimeError("; ".join(errors))
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited nonzero: {bad}")
    return result
