"""Serving launcher (port of ``repro.launch.serve``): build a reduced
vector index over a synthetic corpus and serve batched k-NN queries, with
recall against exact search.

  PYTHONPATH=src python -m repro_torch.launch.serve --corpus 20000 \\
      --dim 256 --spec "qpad32>ivf64x8>pq8x256:i8@kernel>rr40" --batches 5

The pipeline is declared either with ``--spec`` (the index-spec grammar:
``qpad<m> > ivf<nlist>x<nprobe> > pq<M>x<K>[:f32|bf16|i8][@jnp|kernel] >
rr<n>``) or with the individual flags (``--index``/``--nlist``/...), which
are lowered onto the same spec. Each batch prints its latency and its
recall@k against ``knn_search``, which is kernel K3 on the card. Runs on
``cuda`` unless ``main`` is given another device.

Mutable serving: ``--stream`` makes the engine streaming
(``StreamConfig(delta_capacity=--delta-capacity, background_compact=
--background-compact)``) and runs the JAX launcher's write leg beside the
reads: before each search batch it upserts ``--write-batch`` perturbed
rows under fresh ids and, from the second batch on, deletes an eighth of
the previous batch's ids; at the end it prints the write rate and
compacts.

Persistence, as in the JAX launcher: ``--durable DIR`` makes the
streaming engine durable (``DurabilityConfig(fsync=--fsync,
group_commit_ms=--group-commit-ms)``: a write-ahead log under
``DIR/wal`` and the initial snapshot), then reloads it from ``DIR``
through the recovery path, as an operator would after a crash, and
serves the recovered engine; at the end it prints the WAL's counters
from ``engine.metrics()``, as the JAX launcher does. ``--snapshot-dir
DIR`` saves the engine there and serves the one ``load_engine``
restores.

Observability, as in the JAX launcher: ``--metrics-port N`` serves the
engine's typed metrics snapshot (``SearchEngine.metrics()``) from a
stdlib http.server thread (``GET /metrics`` Prometheus text, ``GET
/metrics.json`` the flattened JSON; port 0 binds an ephemeral port and
prints it). ``--trace-dir DIR`` exports a Chrome-trace JSON of the
served batches, ``--slow-query-ms T`` captures over-threshold searches
into a ring buffer, ``--deep-trace-every N`` re-runs 1-in-N batches
through the staged pipeline for per-stage latency, and ``--recall-every
N`` shadow-checks 1-in-N batches against exact search (K3 on the card)
to estimate live recall; any of these turns on the ``latency.*``
histograms and prints their lines at the end.

Sharded serving, as in the JAX launcher: ``--shards N`` splits the
engine over an N-rank serving mesh (``SearchEngine.shard``; ``--donate``
frees the dense state once each rank holds its slice). One process a
rank: under torchrun this process is one of them; otherwise ``main``
starts the N ranks on 127.0.0.1 (``launch.mesh.run_ranks``), every rank
builds the same engine and serves the same batches, rank 0 prints and
its result is returned. ``--mesh device`` is NCCL, one rank a card;
``--mesh host`` is gloo with every rank on the caller's device (the CPU,
or several ranks on one card). With ``--snapshot-dir`` rank 0 saves and
every rank restores onto the mesh (``load_engine(dir, mesh=...)``).
``--durable`` is single-rank: one write-ahead log has one writer.

The read-only, streaming, persistence, observability and sharding flags
are ported with the JAX launcher's names and defaults. The JAX
launcher's ``--interpret`` selects the Pallas interpret mode and has no
counterpart: ``@kernel`` here launches the CUDA kernels.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import sys
import time
import urllib.request
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, cpu_generator, resolve_device
from repro_torch.core.mpad import MPADConfig
from repro_torch.data.synthetic import make_clustered
from repro_torch.launch.mesh import make_serving_mesh, run_ranks
from repro_torch.search.knn import knn_search, recall_at_k
from repro_torch.search.durability.wal import DurabilityConfig
from repro_torch.search.metrics import MetricsServer
from repro_torch.search.segments import StreamConfig
from repro_torch.search.serve import build_engine
from repro_torch.search.snapshot import load_engine
from repro_torch.search.spec import (Coarse, Code, IndexSpec, Reduce, Rerank,
                                     format_spec, parse_spec)

__all__ = ["main"]


def _parse_args(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--spec", default=None,
                    help="index pipeline spec string, e.g. "
                         "'qpad32>ivf64x8>pq8x256:i8' — overrides "
                         "--target-dim/--index/--nlist/--nprobe/"
                         "--pq-subspaces/--lut-dtype/--pq-backend")
    ap.add_argument("--target-dim", type=int, default=32,
                    help="reduction target (0 = no reduction)")
    ap.add_argument("--reducer", choices=["qpad", "pca", "mlp"],
                    default="qpad",
                    help="Reduce-stage kind (ignored when --target-dim is 0)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--index", choices=["flat", "ivf", "pq", "opq", "ivfpq"],
                    default="flat")
    ap.add_argument("--nlist", type=int, default=64)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--pq-subspaces", type=int, default=8)
    ap.add_argument("--lut-dtype", choices=["f32", "bf16", "int8"],
                    default="f32", help="ADC lookup-table precision")
    ap.add_argument("--pq-backend", choices=["jnp", "kernel"], default="jnp",
                    help="ADC scoring: jnp = the plain version, kernel = "
                         "the CUDA kernels")
    ap.add_argument("--query-bucket", type=int, default=64,
                    help="min padded query-batch size; ragged batches round "
                         "up to powers of two")
    ap.add_argument("--stream", action="store_true",
                    help="mutable serving: interleave a 90/10 read/write "
                         "workload (upserts into the delta segment, "
                         "tombstoned deletes, auto-compaction)")
    ap.add_argument("--delta-capacity", type=int, default=512,
                    help="--stream: delta segment size (rows)")
    ap.add_argument("--write-batch", type=int, default=64,
                    help="--stream: rows per upsert batch")
    ap.add_argument("--background-compact", action="store_true",
                    help="--stream: fold the delta on a worker thread and "
                         "swap instead of blocking searches")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="save the engine into DIR and serve the restored "
                         "engine (a snapshot round trip)")
    ap.add_argument("--durable", default=None, metavar="DIR",
                    help="--stream: WAL-log every write under DIR and "
                         "serve the engine recovered from DIR")
    ap.add_argument("--fsync", choices=["always", "batch", "never"],
                    default="batch", help="--durable: WAL fsync mode")
    ap.add_argument("--group-commit-ms", type=float, default=0.0,
                    help="--durable --fsync always: coalesce fsyncs over "
                         "this gathering window")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve SearchEngine.metrics() over HTTP from a "
                         "background thread: /metrics (Prometheus text), "
                         "/metrics.json (JSON); 0 = ephemeral port")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="export a Chrome-trace JSON of the served batches "
                         "into DIR; implies latency histograms")
    ap.add_argument("--slow-query-ms", type=float, default=None, metavar="T",
                    help="capture searches slower than T ms into the "
                         "tracer's slow-query ring buffer (printed at the "
                         "end of the run)")
    ap.add_argument("--deep-trace-every", type=int, default=0, metavar="N",
                    help="re-run 1-in-N batches through the staged pipeline "
                         "for per-stage latency (0 = off; read-only "
                         "engines only)")
    ap.add_argument("--recall-every", type=int, default=0, metavar="N",
                    help="shadow-check 1-in-N batches against exact search "
                         "and keep the recall.estimate_at_k gauge (0 = off)")
    ap.add_argument("--shards", type=int, default=0,
                    help="partition the engine over an N-rank serving mesh "
                         "(data-parallel sharded serving; 0 = one device)")
    ap.add_argument("--mesh", choices=["device", "host"], default="device",
                    help="mesh backend: 'device' = NCCL, one rank a card; "
                         "'host' = gloo, every rank on the caller's device "
                         "(the CPU, or several ranks on one card)")
    ap.add_argument("--donate", action="store_true",
                    help="with --shards: free the dense EngineState once "
                         "each rank holds its slice (no 2x memory)")
    return ap.parse_args(argv)


def _spec_from_flags(args) -> IndexSpec:
    """Lower the individual flags onto a pipeline spec (one build path)."""
    return IndexSpec(
        reduce=(Reduce(args.target_dim, kind=args.reducer)
                if args.target_dim else None),
        coarse=(Coarse(nlist=args.nlist, nprobe=args.nprobe)
                if args.index in ("ivf", "ivfpq") else None),
        code=(Code(kind="opq" if args.index == "opq" else "pq",
                   subspaces=args.pq_subspaces, centroids=256,
                   lut_dtype=args.lut_dtype, backend=args.pq_backend)
              if args.index in ("pq", "opq", "ivfpq") else None),
        rerank=Rerank(4 * args.k))


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _scrape(url: str) -> List[str]:
    """GET ``url`` (the launcher's own metrics endpoint on localhost)."""
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read().decode().splitlines()


def _tracing(engine, args) -> bool:
    """Attach a tracer when any observability flag asks for one (the
    metrics endpoint serves its latency histograms); prints what is on."""
    if not (args.trace_dir is not None or args.slow_query_ms is not None
            or args.deep_trace_every or args.recall_every
            or args.metrics_port is not None):
        return False
    engine.tracing(trace_dir=args.trace_dir,
                   slow_query_ms=args.slow_query_ms,
                   deep_trace_every=args.deep_trace_every,
                   recall_every=args.recall_every)
    knobs = ["histograms"]
    if args.trace_dir is not None:
        knobs.append(f"trace_dir={args.trace_dir}")
    if args.slow_query_ms is not None:
        knobs.append(f"slow_query_ms={args.slow_query_ms}")
    if args.deep_trace_every:
        knobs.append(f"deep_trace_every={args.deep_trace_every}")
    if args.recall_every:
        knobs.append(f"recall_every={args.recall_every}")
    print(f"tracing on ({', '.join(knobs)})")
    return True


def _trace_report(engine, args) -> dict:
    """The JAX launcher's end-of-run latency, recall, stage and slow-query
    lines; returns the flattened metrics they read."""
    flat = engine.metrics().flatten()
    print(f"latency: p50={flat['latency.search.p50']:.2f}ms "
          f"p95={flat['latency.search.p95']:.2f}ms "
          f"p99={flat['latency.search.p99']:.2f}ms over "
          f"{flat['latency.queries']} traced searches")
    if args.recall_every:
        est = flat.get("recall.estimate_at_k")
        if est is not None:
            print(f"recall estimate: {est:.4f}@{flat['recall.k']} "
                  f"({flat['recall.samples']} shadow samples)")
    if args.deep_trace_every:
        stages = sorted((name.split(".")[2], flat[name]) for name in flat
                        if name.startswith("latency.stages.")
                        and name.endswith(".p50"))
        if stages:
            share = ", ".join(f"{s}={ms:.2f}ms" for s, ms in stages)
            print(f"deep-trace stage p50: {share} "
                  f"({flat['latency.deep_traces']} samples)")
    if args.slow_query_ms is not None:
        log = engine.tracer.slow_query_log()
        print(f"slow queries (>{args.slow_query_ms}ms): "
              f"{flat['latency.slow_queries']} captured, "
              f"{len(log)} in the ring")
        for entry in log[-3:]:
            print(f"  seq={entry['seq']} {entry['e2e_ms']:.2f}ms "
                  f"batch={entry['batch']} bucket={entry['bucket']} "
                  f"nprobe={entry['nprobe']} spec={entry['spec']}")
    if args.trace_dir is not None:
        print(f"trace written: {engine.flush_trace()}")
    return flat


def main(argv: Optional[List[str]] = None, device: DeviceLike = None):
    """Parse ``argv`` (the command line when None), build, serve
    ``--batches`` batches and return ``{"spec", "ms_per_batch",
    "recall"}`` (the mean over the batches), and with ``--stream`` also
    ``"stream"``: the rows written, their rate, the grow count and the
    compactions, with ``--durable`` ``"wal"``: the ``wal.*`` section of
    ``engine.metrics()`` after the run, with any tracing flag
    ``"metrics"``: the flattened ``engine.metrics()`` at the end, with
    ``--metrics-port`` ``"scrape"``: the endpoint's last ``/metrics``
    text, and with ``--shards`` ``"sharded"``: the mesh (shards, backend,
    donated) and every batch's ids (numpy), as rank 0 served them."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parse_args(argv)
    if not args.shards:
        return _serve(args, resolve_device(device), None)
    if args.shards < 0:
        raise ValueError("--shards must be >= 0")
    if args.durable:
        raise ValueError(
            "--durable with --shards: every rank would append to the one "
            "write-ahead log; serve a durable engine on one rank")
    backend = "nccl" if args.mesh == "device" else "gloo"
    if backend == "nccl" and device is not None and \
            torch.device(device).type != "cuda":
        raise ValueError(
            f"--mesh device is NCCL, one rank a CUDA card; device {device} "
            "needs --mesh host (gloo)")
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        # under torchrun: this process is one rank of the mesh
        mesh = make_serving_mesh(args.shards, backend=backend, device=device)
        return _serve_rank(mesh, argv)
    return run_ranks(_serve_rank, args.shards, (argv,), backend=backend,
                     device=device)


def _serve_rank(mesh, argv: List[str]):
    """One rank of a sharded launch: the whole serve on this rank's
    engine; rank 0 prints."""
    sink = sys.stdout if mesh.rank == 0 else io.StringIO()
    with contextlib.redirect_stdout(sink):
        return _serve(_parse_args(argv), mesh.device, mesh)


def _serve(args, dev: torch.device, mesh):
    """Build, serve and report (see ``main``); ``mesh`` is this process's
    rank of a sharded launch, or None."""
    spec = parse_spec(args.spec) if args.spec else _spec_from_flags(args)
    gen = cpu_generator(0)
    corpus, _ = make_clustered(gen, args.corpus, 1, args.dim, n_clusters=64,
                               spread=0.4, center_scale=1.5)
    corpus = corpus.to(dev)
    t0 = time.perf_counter()
    runtime = dict(query_bucket=args.query_bucket, fit_sample=4096)
    if args.stream:
        runtime["stream"] = StreamConfig(
            delta_capacity=args.delta_capacity,
            background_compact=args.background_compact)
    if spec.reduce is not None and spec.reduce.kind == "qpad":
        # the MPAD knobs configure the qpad kind only; other reducers
        # own their training hyperparameters
        runtime["mpad"] = MPADConfig(m=spec.reduce.m, iters=64,
                                     batch_size=2048)
    engine = build_engine(corpus, spec, device=dev, **runtime)
    _sync(dev)
    print(f"index built in {time.perf_counter() - t0:.1f}s "
          f"(spec={format_spec(spec)}, kind={spec.kind}, device={dev}"
          + (f", streaming delta={args.delta_capacity}" if args.stream
             else "") + ")")
    if args.durable:
        t0 = time.perf_counter()
        engine.durable(args.durable, DurabilityConfig(
            fsync=args.fsync, group_commit_ms=args.group_commit_ms))
        engine.close()
        # reopen through the recovery path, as an operator would after a
        # crash, and serve the recovered engine
        engine = load_engine(args.durable, device=dev)
        print(f"durable via {args.durable} in "
              f"{time.perf_counter() - t0:.1f}s (fsync={args.fsync}"
              + (f", group_commit_ms={args.group_commit_ms}"
                 if args.group_commit_ms else "")
              + "; every write WAL-logged, served from the recovered "
              "engine)")
    if args.snapshot_dir:
        t0 = time.perf_counter()
        if mesh is None or mesh.rank == 0:
            engine.save(args.snapshot_dir)
        if engine.store is not None:
            engine.close()
        if mesh is not None:
            dist.barrier(group=mesh.group)   # the snapshot is on disk
        engine = load_engine(args.snapshot_dir, mesh=mesh, device=dev)
        print(f"snapshot round-trip via {args.snapshot_dir} in "
              f"{time.perf_counter() - t0:.1f}s (serving from the restored "
              "engine" + (", restored onto the mesh" if mesh is not None
                          else "") + ")")
    if mesh is not None:
        if engine.sharded_state is None and \
                engine._stream_sharded_base is None:
            engine.shard(mesh, donate=args.donate)
        donated = engine.state is None and engine.store is None
        print(f"engine sharded over mesh {mesh.shape} ({mesh.backend}, "
              f"{args.corpus} rows -> ~{-(-args.corpus // mesh.size)} per "
              "shard" + (", dense state donated" if donated else "") + ")")
    tracing_on = _tracing(engine, args)
    server = None
    if args.metrics_port is not None and (mesh is None or mesh.rank == 0):
        server = MetricsServer(engine, port=args.metrics_port)
        print(f"metrics at {server.url} (Prometheus text; /metrics.json "
              "for JSON)")

    served = []
    try:
        total, rec_sum = 0.0, 0.0
        write_s, rows_written, next_id = 0.0, 0, args.corpus
        for i in range(args.batches):
            rows = torch.randint(0, args.corpus, (args.batch,), generator=gen)
            queries = corpus[rows.to(dev)]
            if args.stream:
                # the 10% write leg: a batch of perturbed rows under fresh ids,
                # and an eighth of the previous batch's ids deleted
                wb = args.write_batch
                vecs = corpus[:wb] + 0.01 * torch.randn(
                    (wb, args.dim), generator=gen).to(dev)
                _sync(dev)
                t0 = time.perf_counter()
                engine.upsert(torch.arange(next_id, next_id + wb), vecs)
                if next_id > args.corpus:
                    engine.delete(torch.arange(next_id - wb,
                                               next_id - wb + wb // 8))
                _sync(dev)
                write_s += time.perf_counter() - t0
                rows_written += wb
                next_id += wb
            _sync(dev)
            t0 = time.perf_counter()
            _, ids = engine.search(queries, args.k)
            _sync(dev)
            dt = time.perf_counter() - t0
            _, truth = knn_search(queries, corpus, args.k)
            rec = recall_at_k(ids, truth)
            served.append(ids.cpu().numpy())
            total += dt
            rec_sum += rec
            print(f"batch {i}: {dt * 1e3:7.1f} ms  recall@{args.k}={rec:.4f}")
            if i == 0 and server is not None:
                # mid-traffic scrape: the histogram series are live after the
                # first batch
                hist = [ln for ln in _scrape(server.url)
                        if ln.startswith("qpad_latency_search_seconds")]
                print(f"mid-traffic scrape: {len(hist)} latency-histogram "
                      "samples")
        mean_s = total / args.batches
        print(f"\nmean: {mean_s * 1e3:.1f} ms/batch "
              f"({args.batch / mean_s:.0f} qps), "
              f"recall={rec_sum / args.batches:.4f}")
        out = {"spec": format_spec(spec), "ms_per_batch": mean_s * 1e3,
               "recall": rec_sum / args.batches}
        if args.stream:
            rate = rows_written / write_s if write_s else 0.0
            print(f"writes: {rows_written} rows in {write_s:.2f}s "
                  f"({rate:.0f} rows/s), grow_count={engine.grow_count}")
            t0 = time.perf_counter()
            engine.compact()
            _sync(dev)
            print(f"final compact: {time.perf_counter() - t0:.2f}s "
                  f"(base rows={int(engine.store.n_rows)})")
            out["stream"] = {"rows_written": rows_written, "rows_per_s": rate,
                             "grow_count": engine.grow_count,
                             "compactions": engine.counters["compactions"],
                             "base_rows": int(engine.store.n_rows)}
            m = engine.metrics()
            if m.wal is not None:
                out["wal"] = dataclasses.asdict(m.wal)
                print(f"wal: {m.wal.records} records / {m.wal.bytes} bytes / "
                      f"{m.wal.fsyncs} fsyncs"
                      + (f" ({m.wal.group_commits} group commits)"
                         if m.wal.group_commits else "")
                      + f", {m.wal.replayed} replayed; "
                      f"compactions={m.compact.compactions} "
                      f"vacuums={m.compact.vacuums} "
                      f"rebuilds={m.compact.rebuilds}")
        if mesh is not None:
            out["sharded"] = {"shards": mesh.size, "backend": mesh.backend,
                              "donated": engine.state is None
                              and engine.store is None, "ids": served}
        if tracing_on:
            out["metrics"] = _trace_report(engine, args)
        if server is not None:
            out["scrape"] = _scrape(server.url)
            print("sample scrape (/metrics):")
            for line in out["scrape"][:8]:
                print(f"  {line}")
    finally:
        if server is not None:
            server.close()
    if engine.store is not None:
        engine.close()
    return out


if __name__ == "__main__":
    main()
