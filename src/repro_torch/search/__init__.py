"""Vector search in PyTorch: exact search and A_m(k), spec grammar, the
index kinds and the serving engine (the port of ``repro.search``)."""
# knn first: the kernels' plain versions import its selection helper
from .knn import (amk_accuracy, knn_scan, knn_search, knn_search_blocked,
                  masked_topk, recall_at_k, topk_smallest)
from .registry import BuildInits, Index, ScanParams, get_ops
from .serve import (EngineState, SearchEngine, ServeConfig, build_engine,
                    config_from_spec, exact_rerank, search_fn)
from .spec import (Code, Coarse, IndexSpec, Reduce, Rerank, format_spec,
                   parse_spec, spec_from_config)

__all__ = ["knn_scan", "knn_search", "knn_search_blocked", "amk_accuracy",
           "masked_topk", "recall_at_k", "topk_smallest",
           "BuildInits", "Index", "ScanParams", "get_ops", "EngineState",
           "SearchEngine", "ServeConfig", "build_engine", "config_from_spec",
           "exact_rerank", "search_fn", "Code", "Coarse", "IndexSpec",
           "Reduce", "Rerank", "format_spec", "parse_spec",
           "spec_from_config"]
