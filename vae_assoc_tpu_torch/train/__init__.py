"""Training: the step with its optimizer, and the epoch loops."""

from vae_assoc_tpu_torch.train.eval import cross_modal_mse, evaluate
from vae_assoc_tpu_torch.train.loop import train_loop, train_loop_fused
from vae_assoc_tpu_torch.train.step import (
    TrainState,
    eval_params,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from vae_assoc_tpu_torch.train.sweep import (
    init_sweep_state,
    make_sweep_step,
    select_model,
    sweep_loop,
)

__all__ = [
    "init_sweep_state",
    "make_sweep_step",
    "select_model",
    "sweep_loop",
    "TrainState",
    "eval_params",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
    "train_loop",
    "train_loop_fused",
    "cross_modal_mse",
    "evaluate",
]
