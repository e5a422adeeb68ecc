"""Training: the from-scratch AdamW, checkpoints and the resumable loop,
the port of ``repro.train``."""

from . import checkpoint
from .optimizer import OptimizerConfig, apply_updates, init_opt_state
from .train_loop import (TrainLoop, TrainLoopConfig, TrainState,
                         train_shape_cell)

__all__ = ["OptimizerConfig", "apply_updates", "init_opt_state",
           "TrainLoop", "TrainLoopConfig", "TrainState",
           "train_shape_cell", "checkpoint"]
