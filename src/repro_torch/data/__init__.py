"""Data of the port (port of ``repro.data``): the LM token pipeline, the
recsys batches, the GNN family's random graphs and neighbour sampler, and
the synthetic stand-ins for the paper's evaluation datasets."""
from .graph import make_random_graph, sample_neighborhood_batch
from .pipeline import (deterministic_shard, lm_token_batches,
                       recsys_ranking_batch, twotower_batch)
from .synthetic import (PAPER_DATASETS, make_arcene_like, make_clustered,
                        make_fasttext_like, make_informative_plus_spikes,
                        make_isolet_like, make_pbmc3k_like)

__all__ = ["deterministic_shard", "lm_token_batches",
           "recsys_ranking_batch", "twotower_batch", "PAPER_DATASETS",
           "make_clustered", "make_informative_plus_spikes",
           "make_fasttext_like", "make_isolet_like", "make_arcene_like",
           "make_pbmc3k_like", "make_random_graph",
           "sample_neighborhood_batch"]
