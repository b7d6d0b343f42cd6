"""Mesh construction (port of ``repro.launch.mesh``).

``make_serving_mesh`` (the 1-D serving mesh) and ``make_mesh`` (an N-D
mesh: the counterpart of ``jax.make_mesh``) join (or start) the default
``torch.distributed`` process group and return this process's ``Mesh``
record. Under torchrun the world comes from ``WORLD_SIZE`` / ``RANK`` (and
``MASTER_ADDR`` / ``MASTER_PORT``); a lone process with no such variables
is a world of one. ``make_production_mesh`` gives JAX's production shapes,
(16, 16) over ``("data", "model")`` and (2, 16, 16) over ``("pod", "data",
"model")``. ``run_ranks`` starts the ranks on 127.0.0.1 itself, each of
which builds its mesh and runs a function, for a caller that is not under
torchrun (the serving launcher, the tests); they meet through a file
store.

``backend="nccl"`` is one rank a card and refuses more ranks than cards;
``backend="gloo"`` (the launcher's ``--mesh host``) puts every rank on the
caller's device: CPU tensors, or several ranks on one card.

``fake_world`` joins a world of any size in this one process, as one of
its ranks, on torch's ``"fake"`` backend (``backend="fake"``: the
collectives return at once, moving nothing): the dry-run's way to trace
rank r's program on a 256- or 512-rank production mesh
(``launch.dryrun``). It builds the same per-axis groups ``make_mesh``
builds for a real world, and tears the world down when its block ends.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import pickle
import socket
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.parallel.context import BACKENDS, Mesh

__all__ = ["make_serving_mesh", "make_mesh", "make_production_mesh",
           "production_shape", "fake_world", "run_ranks", "rank_threads",
           "free_port"]


def _join(ranks: int, backend: str, device: DeviceLike,
          init_method: Optional[str], what: str):
    """Join (or start) the default process group of ``ranks`` processes;
    returns (this process's rank, its device)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    if ranks < 1:
        raise ValueError("a mesh needs >= 1 rank")
    if ranks != world:
        raise RuntimeError(
            f"need {ranks} ranks for {what}, the world has {world}: start "
            f"one process a rank (torchrun --nproc-per-node {ranks}, or "
            "repro_torch.launch.mesh.run_ranks)")
    if backend == "fake" and not dist.is_initialized():
        raise RuntimeError("a fake mesh lives in a fake world: build it "
                           "inside repro_torch.launch.mesh.fake_world")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if ranks > cards:
            raise RuntimeError(
                f"need {ranks} CUDA devices for an NCCL mesh (one rank a "
                f"card), have {cards}: use backend='gloo' (the launcher's "
                "--mesh host) to put several ranks on one device")
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
    return rank, dev


def make_serving_mesh(shards: Optional[int] = None, axis: str = "data",
                      backend: str = "nccl", device: DeviceLike = None,
                      init_method: Optional[str] = None) -> Mesh:
    """1-D data-parallel serving mesh of ``shards`` ranks (default: the
    world's size) under ``axis``; returns this process's ``Mesh``.

    Joins the default process group when one is initialized, else starts
    it at ``init_method`` when given, else from torchrun's environment
    where set, else as a world of one on 127.0.0.1. Under ``"nccl"`` rank
    r serves from ``cuda:LOCAL_RANK`` (r without torchrun) and more
    shards than cards is an error; under
    ``"gloo"`` every rank serves from ``device`` (default: CUDA, which must
    be present, unless the caller names the CPU).
    """
    if shards is None:
        shards = (dist.get_world_size() if dist.is_initialized()
                  else int(os.environ.get("WORLD_SIZE", "1")))
    rank, dev = _join(shards, backend, device, init_method,
                      "a serving mesh")
    return Mesh(axis=axis, size=shards, rank=rank,
                group=dist.group.WORLD, backend=backend, device=dev)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              backend: str = "nccl", device: DeviceLike = None,
              init_method: Optional[str] = None) -> Mesh:
    """An N-D mesh of prod(``shape``) ranks named ``axes`` (the
    counterpart of ``jax.make_mesh(shape, axes)``); returns this process's
    ``Mesh``. The world must have exactly that many ranks; it is joined as
    ``make_serving_mesh`` joins it. Ranks are laid out row-major over
    ``axes`` (JAX's device order), and every rank creates every axis's
    process groups in the same order (``torch.distributed.new_group`` is
    collective), keeping its own."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    size = math.prod(shape)
    rank, dev = _join(size, backend, device, init_method,
                      f"a {shape} mesh")
    groups = []
    for i in range(len(axes)):
        mine = None
        others = [range(n) for j, n in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            members = []
            for c in range(shape[i]):
                coord = list(rest)
                coord.insert(i, c)
                members.append(_ravel(coord, shape))
            g = dist.new_group(members)
            if rank in members:
                mine = g
        groups.append(mine)
    return Mesh(axis=axes[0], size=size, rank=rank, group=dist.group.WORLD,
                backend=backend, device=dev, names=axes, dims=shape,
                groups=tuple(groups))


def _ravel(coord: Sequence[int], shape: Sequence[int]) -> int:
    r = 0
    for c, n in zip(coord, shape):
        r = r * n + c
    return r


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of JAX's production mesh: (16, 16) over
    ``("data", "model")``, or with ``multi_pod`` (2, 16, 16) over
    ``("pod", "data", "model")``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(multi_pod: bool = False) -> Mesh:
    """JAX's production mesh (``production_shape``), 256 or 512 ranks, one
    rank a card (``make_mesh``'s defaults). A world of another size raises
    ``RuntimeError``, as JAX's does with too few devices."""
    return make_mesh(*production_shape(multi_pod))


@contextlib.contextmanager
def fake_world(shape: Sequence[int], axes: Sequence[str], rank: int = 0,
               device: DeviceLike = "cuda"):
    """Join a world of prod(``shape``) ranks as rank ``rank``, in this one
    process, on torch's fake process group, and yield rank ``rank``'s
    ``Mesh`` over ``axes`` (``backend="fake"``, its tensors on
    ``device``); the world is destroyed when the block ends. A process
    that already has a default group raises: run a fake world in a
    process of its own (the dry-run's tests and ``chip_smoke.py`` start
    one), so that nothing after it finds a group initialised."""
    # torch's fake process group lives in its testing package: a missing
    # module fails here, loudly
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("this process already has a default process "
                           "group; start the fake world in a fresh process")
    world = math.prod(int(n) for n in shape)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield make_mesh(shape, axes, backend="fake", device=device)
    finally:
        dist.destroy_process_group()


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


def _rank_main(rank: int, shards, store: str, backend: str, device,
               axis, job: str, queue):
    world = shards if isinstance(shards, int) else math.prod(shards)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(rank_threads(world))
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        init = f"file://{store}"
        if isinstance(shards, int):
            mesh = make_serving_mesh(world, axis=axis, backend=backend,
                                     device=device, init_method=init)
        else:
            mesh = make_mesh(shards, axis, backend=backend, device=device,
                             init_method=init)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out if rank == 0 else None))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, shards: Union[int, Tuple[int, ...]],
              args: Sequence[Any] = (), *, backend: str = "gloo",
              device: DeviceLike = None,
              axis: Union[str, Tuple[str, ...]] = "data",
              timeout: float = 600.0):
    """Run ``fn(mesh, *args)`` in new processes on 127.0.0.1, one a rank:
    ``shards`` ranks of a serving mesh under ``axis``, or, given a shape
    (a tuple) and its axis names (a tuple, e.g. ``(2, 2)`` and ``("data",
    "model")``), the ranks of that N-D mesh (``make_mesh``). Each rank
    takes ``rank_threads(world)`` CPU threads. Returns rank 0's return
    value (which must pickle; return
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

    if isinstance(shards, int) != isinstance(axis, str):
        raise ValueError("a 1-D mesh takes a rank count and an axis name, "
                         "an N-D one a shape and a tuple of names")
    world = shards if isinstance(shards, int) else math.prod(shards)
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
             for r in range(world)]
    for p in procs:
        p.start()
    result, errors, reported = None, [], set()
    deadline = time.monotonic() + timeout
    try:
        while len(reported) < world:
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
                    errors.append(f"ranks {sorted(set(range(world)) - reported)}"
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
