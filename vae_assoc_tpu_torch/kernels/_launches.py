"""Launch counters of the hand-written kernels.

Each wrapper adds one to its kernel's count where it launches it, and
nowhere else, so a run can show that its main path went through the
kernels. ``SERVING`` holds the forward kernels that serving runs: the MLP
stacks (kernels/mlp.py) and the conv primitive (kernels/conv.py, which the
training step also launches, for the forward and the input gradients).
``TRAINING`` holds the other kernels of the training step: the tower
megakernel (kernels/megakernel.py), the stack backwards and the weight grads
(kernels/mlp.py), the sampler (kernels/sampling.py), the joint loss
(kernels/loss.py), the conv weight gradient (kernels/conv.py), the
conv-tower megakernel (kernels/conv_mega.py), and the sketch tower's LSTM
steps (kernels/lstm.py) and mixture loss (kernels/mixture.py).

Both tables are counter groups of ``utils/spans.py``, the port's one
counter system. A count is a host call: a launch replayed inside a CUDA
graph adds nothing.
"""

from __future__ import annotations

from vae_assoc_tpu_torch.utils.spans import Counters

SERVING = Counters(("enc_fwd", "dec_fwd", "conv_fwd"))
TRAINING = Counters(("mega_fwd", "mega_dec_loss_bwd", "enc_bwd", "dec_bwd",
                     "wgrad", "reparam", "loss_fwd", "loss_bwd",
                     "conv_dw", "conv_enc", "conv_dec", "lstm_fwd", "lstm_bwd",
                     "mixture_loss"))


def count(table: Counters, name: str) -> None:
    if name not in table:
        raise KeyError(f"no launch counter {name!r}")
    table.add(name, shared=True)  # kernels launch from any thread


def reset() -> None:
    """Set every count to zero."""
    SERVING.reset()
    TRAINING.reset()


def snapshot() -> dict:
    """Every kernel's count, by name."""
    return {**SERVING.snapshot(), **TRAINING.snapshot()}
