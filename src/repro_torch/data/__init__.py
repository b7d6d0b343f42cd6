"""Data of the port (port of ``repro.data``): the LM token pipeline and
the synthetic stand-ins for the paper's evaluation datasets."""
from .pipeline import deterministic_shard, lm_token_batches
from .synthetic import (PAPER_DATASETS, make_arcene_like, make_clustered,
                        make_fasttext_like, make_informative_plus_spikes,
                        make_isolet_like, make_pbmc3k_like)

__all__ = ["deterministic_shard", "lm_token_batches", "PAPER_DATASETS",
           "make_clustered", "make_informative_plus_spikes",
           "make_fasttext_like", "make_isolet_like", "make_arcene_like",
           "make_pbmc3k_like"]
