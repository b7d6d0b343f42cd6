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

The read-only flags are ported with the JAX launcher's names and
defaults. Its other flags are accepted and raise ``NotImplementedError``
naming the ``ROADMAP.md`` item that ports them (streaming, durability,
snapshots, sharding, metrics and tracing), as does the ``ivf`` index kind.
The JAX launcher's ``--interpret`` selects the Pallas interpret mode and
has no counterpart: ``@kernel`` here launches the CUDA kernels.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch._device import DeviceLike, cpu_generator, resolve_device
from repro_torch.core.mpad import MPADConfig
from repro_torch.data.synthetic import make_clustered
from repro_torch.search.knn import knn_search, recall_at_k
from repro_torch.search.serve import build_engine
from repro_torch.search.spec import (Coarse, Code, IndexSpec, Reduce, Rerank,
                                     format_spec, parse_spec)

__all__ = ["main"]

_ITEM = "see ROADMAP.md, 'Modules still to port', item"
# flag -> (argparse keywords, ROADMAP item that ports what it turns on)
_UNPORTED = {
    "--snapshot-dir": (dict(default=None, metavar="DIR"),
                       "7 (snapshot read and write)"),
    "--shards": (dict(type=int, default=0), "11 (multi-GPU)"),
    "--mesh": (dict(choices=["device", "host"], default="device"),
               "11 (multi-GPU)"),
    "--donate": (dict(action="store_true"), "11 (multi-GPU)"),
    "--stream": (dict(action="store_true"), "8 (streaming)"),
    "--delta-capacity": (dict(type=int, default=512), "8 (streaming)"),
    "--write-batch": (dict(type=int, default=64), "8 (streaming)"),
    "--background-compact": (dict(action="store_true"), "8 (streaming)"),
    "--durable": (dict(default=None, metavar="DIR"),
                  "9 (durability and replication)"),
    "--fsync": (dict(choices=["always", "batch", "never"], default="batch"),
                "9 (durability and replication)"),
    "--group-commit-ms": (dict(type=float, default=0.0),
                          "9 (durability and replication)"),
    "--metrics-port": (dict(type=int, default=None, metavar="PORT"),
                       "10 (observability)"),
    "--trace-dir": (dict(default=None, metavar="DIR"), "10 (observability)"),
    "--slow-query-ms": (dict(type=float, default=None, metavar="T"),
                        "10 (observability)"),
    "--deep-trace-every": (dict(type=int, default=0, metavar="N"),
                           "10 (observability)"),
    "--recall-every": (dict(type=int, default=0, metavar="N"),
                       "10 (observability)"),
}


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
    for flag, (kw, item) in _UNPORTED.items():
        ap.add_argument(flag, help=f"not ported yet ({_ITEM} {item})", **kw)
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


def main(argv: Optional[List[str]] = None, device: DeviceLike = None):
    """Parse ``argv`` (the command line when None), build, serve
    ``--batches`` batches and return ``{"spec", "ms_per_batch",
    "recall"}`` (the mean over the batches)."""
    args = _parse_args(argv)
    for flag, (kw, item) in _UNPORTED.items():
        given = getattr(args, flag[2:].replace("-", "_"))
        if given != kw.get("default", False):       # store_true: False
            raise NotImplementedError(f"{flag} is not ported yet ({_ITEM} "
                                      f"{item})")
    spec = parse_spec(args.spec) if args.spec else _spec_from_flags(args)
    if spec.kind == "ivf":
        raise NotImplementedError(f"the ivf index kind is not ported yet "
                                  f"({_ITEM} 4)")
    dev = resolve_device(device)
    gen = cpu_generator(0)
    corpus, _ = make_clustered(gen, args.corpus, 1, args.dim, n_clusters=64,
                               spread=0.4, center_scale=1.5)
    corpus = corpus.to(dev)
    t0 = time.perf_counter()
    runtime = dict(query_bucket=args.query_bucket, fit_sample=4096)
    if spec.reduce is not None and spec.reduce.kind == "qpad":
        # the MPAD knobs configure the qpad kind only; other reducers
        # own their training hyperparameters
        runtime["mpad"] = MPADConfig(m=spec.reduce.m, iters=64,
                                     batch_size=2048)
    engine = build_engine(corpus, spec, device=dev, **runtime)
    _sync(dev)
    print(f"index built in {time.perf_counter() - t0:.1f}s "
          f"(spec={format_spec(spec)}, kind={spec.kind}, device={dev})")

    total, rec_sum = 0.0, 0.0
    for i in range(args.batches):
        rows = torch.randint(0, args.corpus, (args.batch,), generator=gen)
        queries = corpus[rows.to(dev)]
        _sync(dev)
        t0 = time.perf_counter()
        _, ids = engine.search(queries, args.k)
        _sync(dev)
        dt = time.perf_counter() - t0
        _, truth = knn_search(queries, corpus, args.k)
        rec = recall_at_k(ids, truth)
        total += dt
        rec_sum += rec
        print(f"batch {i}: {dt * 1e3:7.1f} ms  recall@{args.k}={rec:.4f}")
    mean_s = total / args.batches
    print(f"\nmean: {mean_s * 1e3:.1f} ms/batch "
          f"({args.batch / mean_s:.0f} qps), "
          f"recall={rec_sum / args.batches:.4f}")
    return {"spec": format_spec(spec), "ms_per_batch": mean_s * 1e3,
            "recall": rec_sum / args.batches}


if __name__ == "__main__":
    main()
