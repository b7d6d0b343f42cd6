"""Vector search in PyTorch: exact search and A_m(k), spec grammar, the
index kinds, the serving engine, its streaming write path, snapshots and
durability (the port of ``repro.search``)."""
# knn first: the kernels' plain versions import its selection helper
from .knn import (amk_accuracy, knn_scan, knn_search, knn_search_blocked,
                  masked_topk, recall_at_k, topk_smallest)
from .registry import BuildInits, Index, ScanParams, get_ops
from .durability import Decision, MaintenancePolicy, PolicyConfig
from .segments import (FrozenParams, StreamConfig, StreamStore, compact_fn,
                       delete_fn, grow_store, make_mutable, rebuild_state,
                       upsert_fn)
from .serve import (EngineState, SearchEngine, ServeConfig, build_engine,
                    config_from_spec, exact_rerank, search_fn)
from .stream import stream_search_fn
from .snapshot import load_engine, save_engine
from .spec import (Code, Coarse, IndexSpec, Reduce, Rerank, format_spec,
                   parse_spec, spec_from_config)

__all__ = ["knn_scan", "knn_search", "knn_search_blocked", "amk_accuracy",
           "masked_topk", "recall_at_k", "topk_smallest",
           "BuildInits", "Index", "ScanParams", "get_ops", "EngineState",
           "SearchEngine", "ServeConfig", "build_engine", "config_from_spec",
           "exact_rerank", "search_fn", "stream_search_fn", "save_engine",
           "load_engine", "StreamConfig",
           "StreamStore", "FrozenParams", "make_mutable", "upsert_fn",
           "delete_fn", "compact_fn", "grow_store", "rebuild_state",
           "PolicyConfig", "MaintenancePolicy", "Decision", "Code", "Coarse",
           "IndexSpec", "Reduce", "Rerank", "format_spec", "parse_spec",
           "spec_from_config"]
