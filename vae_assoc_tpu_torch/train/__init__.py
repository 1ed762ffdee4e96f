"""Training: the step with its optimizer, and the epoch loops."""

from vae_assoc_tpu_torch.train.loop import train_loop, train_loop_fused
from vae_assoc_tpu_torch.train.step import (
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "TrainState",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
    "train_loop",
    "train_loop_fused",
]
