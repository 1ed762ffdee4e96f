"""Launch counters of the hand-written kernels.

Each wrapper adds one to its kernel's count where it launches it, and
nowhere else, so a run can show that its main path went through the
kernels. ``SERVING`` holds the forward kernels that serving runs: the MLP
stacks (kernels/mlp.py) and the conv primitive (kernels/conv.py, which the
training step also launches, for the forward and the input gradients).
``TRAINING`` holds the other kernels of the training step: the tower
megakernel (kernels/megakernel.py), the stack backwards and the weight grads
(kernels/mlp.py), the sampler (kernels/sampling.py), the joint loss
(kernels/loss.py), the conv weight gradient (kernels/conv.py) and the
conv-tower megakernel (kernels/conv_mega.py).
"""

from __future__ import annotations

import threading

SERVING = {"enc_fwd": 0, "dec_fwd": 0, "conv_fwd": 0}
TRAINING = {"mega_fwd": 0, "mega_dec_loss_bwd": 0, "enc_bwd": 0, "dec_bwd": 0,
            "wgrad": 0, "reparam": 0, "loss_fwd": 0, "loss_bwd": 0,
            "conv_dw": 0, "conv_enc": 0, "conv_dec": 0}

_lock = threading.Lock()


def count(table: dict, name: str) -> None:
    with _lock:
        table[name] += 1


def reset() -> None:
    """Set every count to zero."""
    with _lock:
        for table in (SERVING, TRAINING):
            for k in table:
                table[k] = 0


def snapshot() -> dict:
    """Every kernel's count, by name."""
    with _lock:
        return {**SERVING, **TRAINING}
