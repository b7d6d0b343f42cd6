"""Data pipelines of the port (port of the LM part of ``repro.data``)."""
from .pipeline import deterministic_shard, lm_token_batches

__all__ = ["deterministic_shard", "lm_token_batches"]
