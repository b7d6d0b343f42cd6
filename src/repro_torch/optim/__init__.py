"""Optimizers of the port (port of ``repro.optim``)."""
from .adamw import AdamWConfig, adamw_update, global_norm, init_opt_state, \
    init_zero_opt_state, make_train_step, sharded_adamw_update, \
    sharded_global_norm, value_and_grad
from .compression import (CompressionState, compress_int8, decompress_int8,
                          ef_compress_update, init_compression_state)

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "make_train_step",
           "compress_int8", "decompress_int8", "ef_compress_update",
           "CompressionState", "init_compression_state", "global_norm",
           "value_and_grad", "init_zero_opt_state", "sharded_global_norm",
           "sharded_adamw_update"]
