"""Vector search in PyTorch: spec grammar, IVF-PQ index and the serving
engine (the port of ``repro.search``)."""
# knn first: the kernels' plain versions import its selection helper
from .knn import knn_scan, masked_topk, recall_at_k, topk_smallest
from .registry import BuildInits, Index, ScanParams, get_ops
from .serve import (EngineState, SearchEngine, ServeConfig, build_engine,
                    config_from_spec, exact_rerank, search_fn)
from .spec import (Code, Coarse, IndexSpec, Reduce, Rerank, format_spec,
                   parse_spec, spec_from_config)

__all__ = ["knn_scan", "masked_topk", "recall_at_k", "topk_smallest",
           "BuildInits", "Index", "ScanParams", "get_ops", "EngineState",
           "SearchEngine", "ServeConfig", "build_engine", "config_from_spec",
           "exact_rerank", "search_fn", "Code", "Coarse", "IndexSpec",
           "Reduce", "Rerank", "format_spec", "parse_spec",
           "spec_from_config"]
