"""Vector search in PyTorch: exact search and A_m(k), the IVF-Flat / PQ /
OPQ / IVF-PQ indexes, the composable index-spec API (pipeline specs, the
tagged index union and its ops registry, the reducer zoo), the serving
engine, its streaming write path, snapshots, durability (write-ahead log,
crash recovery, maintenance policy), replication (WAL shipping and
follower catch-up), the typed metrics surface, request-level tracing,
and sharded serving over a ``torch.distributed`` mesh, read-only and
streaming (the port of ``repro.search``). ``jax_profile`` is
``torch_profile`` here.
"""
# knn first: the kernels' plain versions import its selection helper
from .knn import (amk_accuracy, knn_scan, knn_search, knn_search_blocked,
                  masked_topk, recall_at_k, topk_smallest)
from .ivf import (IVFIndex, balance_cells, build_ivf, cell_vectors,
                  ivf_search, posting_lists, probe_cells)
from .ivfpq import IVFPQIndex, build_ivfpq, ivfpq_search
from .pq import PQIndex, build_pq, pq_reconstruct, pq_search
from .reducers import (REDUCER_KINDS, Reducer, ReducerOps, fit_reducer,
                       get_reducer_ops, reduce_vectors, reducer_dim,
                       register_reducer)
from .registry import (INDEX_KINDS, BuildInits, Index, IndexOps, ScanParams,
                       get_ops, register_index)
from .durability import (CatchUpStats, Decision, DivergenceError,
                         DurabilityConfig, LocalDirSource, MaintenancePolicy,
                         PolicyConfig, ReplayStats, ReplicationError, Wal,
                         WalError, WalSource, catch_up, replay,
                         replay_records, seed_follower)
from .segments import (FrozenParams, MutableEngineState, StreamConfig,
                       StreamStore, compact_fn, delete_fn, grow_store,
                       make_mutable, rebuild_state, upsert_fn)
from .serve import (EngineState, SearchEngine, ServeConfig,
                    ShardedEngineState, as_serve_config, build_engine,
                    config_from_spec, exact_rerank, search_fn,
                    sharded_search_fn)
from .stream import (StreamReplica, replica_from_store,
                     sharded_stream_search_fn, stream_search_fn)
from .snapshot import load_engine, save_engine
from .spec import (Code, Coarse, IndexSpec, Reduce, Rerank, format_spec,
                   parse_spec, spec_from_config)
from .metrics import (CompactMetrics, EngineInfo, EngineMetrics,
                      HistogramSnapshot, LatencyMetrics, MetricsServer,
                      PolicyMetrics, RecallMetrics, ReplicationMetrics,
                      SnapshotMetrics, StreamMetrics, WalMetrics,
                      collect_metrics, render_prometheus)
from .tracing import (LatencyHistogram, TraceConfig, Tracer, deep_trace,
                      shadow_recall, torch_profile)

__all__ = [
    "knn_scan", "knn_search", "knn_search_blocked", "masked_topk",
    "recall_at_k", "amk_accuracy", "topk_smallest",
    "IVFIndex", "build_ivf", "cell_vectors", "ivf_search", "posting_lists",
    "probe_cells", "balance_cells",
    "IVFPQIndex", "build_ivfpq", "ivfpq_search",
    "PQIndex", "build_pq", "pq_search", "pq_reconstruct",
    # the composable index-spec API
    "IndexSpec", "Reduce", "Coarse", "Code", "Rerank",
    "parse_spec", "format_spec", "spec_from_config", "config_from_spec",
    "as_serve_config",
    "Index", "IndexOps", "ScanParams", "BuildInits", "get_ops",
    "register_index",
    # the reducer zoo (pluggable Reduce stage)
    "Reducer", "ReducerOps", "register_reducer", "get_reducer_ops",
    "fit_reducer", "reduce_vectors", "reducer_dim", "REDUCER_KINDS",
    # engine + lifecycle
    "SearchEngine", "ServeConfig", "EngineState", "build_engine",
    "save_engine", "load_engine", "search_fn", "exact_rerank",
    "INDEX_KINDS",
    # sharded serving
    "ShardedEngineState", "sharded_search_fn", "sharded_stream_search_fn",
    "StreamReplica", "replica_from_store",
    # streaming
    "StreamConfig", "StreamStore", "MutableEngineState", "FrozenParams",
    "make_mutable", "upsert_fn", "delete_fn", "compact_fn", "grow_store",
    "rebuild_state", "stream_search_fn",
    # durability: WAL + crash recovery + maintenance policy
    "DurabilityConfig", "Wal", "WalError", "replay", "ReplayStats",
    "replay_records",
    "PolicyConfig", "MaintenancePolicy", "Decision",
    # replication: WAL shipping + follower catch-up
    "ReplicationError", "DivergenceError", "WalSource", "LocalDirSource",
    "CatchUpStats", "catch_up", "seed_follower",
    # typed metrics / observability
    "EngineMetrics", "EngineInfo", "StreamMetrics", "CompactMetrics",
    "PolicyMetrics", "WalMetrics", "SnapshotMetrics", "ReplicationMetrics",
    "HistogramSnapshot", "LatencyMetrics", "RecallMetrics",
    "collect_metrics", "render_prometheus", "MetricsServer",
    # request-level tracing
    "TraceConfig", "Tracer", "LatencyHistogram", "deep_trace",
    "shadow_recall", "torch_profile",
]
