"""Checkpointing and fault tolerance of the port (port of
``repro.runtime``)."""
from .checkpoint import (checkpoint_step, latest_checkpoint,
                         restore_checkpoint, restore_resharded, save_arrays,
                         save_checkpoint)
from .fault import FailureInjector, run_with_restarts

__all__ = ["save_checkpoint", "save_arrays", "restore_checkpoint",
           "restore_resharded", "latest_checkpoint", "checkpoint_step",
           "run_with_restarts", "FailureInjector"]
