"""Checkpointing and fault tolerance of the port (port of
``repro.runtime``; ``restore_resharded`` waits for multi-GPU)."""
from .checkpoint import (checkpoint_step, latest_checkpoint,
                         restore_checkpoint, save_arrays, save_checkpoint)
from .fault import FailureInjector, run_with_restarts

__all__ = ["save_checkpoint", "save_arrays", "restore_checkpoint",
           "latest_checkpoint", "checkpoint_step", "run_with_restarts",
           "FailureInjector"]
