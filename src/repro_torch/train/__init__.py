"""Training: AdamW, the training step and checkpoints in the store."""

from .checkpoint import CheckpointManager
from .optimizer import AdamWConfig, OptState, cosine_schedule, make_adamw
from .step import (TensorSpec, TrainState, init_train_state, make_train_step,
                   train_state_specs)

__all__ = [
    "AdamWConfig", "CheckpointManager", "OptState", "TensorSpec",
    "TrainState", "cosine_schedule", "init_train_state", "make_adamw",
    "make_train_step", "train_state_specs",
]
