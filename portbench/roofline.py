"""The chip's peaks and a training step's least work, for the rooflines and MFU.

Peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet, dense):
3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s
bf16 on them. A step's FLOPs are counted by ``torch.utils.flop_counter``
over the plain reference (reference/model.py) on the ``meta`` device at the
cell's shapes: forward and backward of every product and conv, the data's
own input gradient left out, nothing recomputed.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import model as ref

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}


def step_flops(model: dict, batch: int, conv_channels=(32, 64)) -> int:
    """Model FLOPs of one training step (forward and backward) at ``batch``."""
    spec = ref.param_spec(model, conv_channels)
    meta = torch.device("meta")
    p = {n: torch.empty(s, device=meta, requires_grad=True) for n, s, _, _ in spec}
    xs = [torch.empty(batch, int(m["arch"]["n_input"]), device=meta) for m in model["modalities"]]
    eps = [torch.empty(batch, int(m["arch"]["n_z"]), device=meta) for m in model["modalities"]]
    with FlopCounterMode(display=False) as counter:
        total = ref.loss(p, model, xs, eps)
        torch.autograd.grad(total, list(p.values()))
    return int(counter.get_total_flops())


def n_params(model: dict, conv_channels=(32, 64)) -> int:
    return sum(math.prod(s) for _, s, _, _ in ref.param_spec(model, conv_channels))


def step_bytes(model: dict, batch: int, conv_channels=(32, 64)) -> int:
    """Compulsory bytes of one Adam step in fp32: the batch, the weights and
    both moments read once; the weights and both moments written once."""
    rows = sum(int(m["arch"]["n_input"]) for m in model["modalities"])
    return 4 * batch * rows + 4 * 6 * n_params(model, conv_channels)


def least_step_s(model: dict, batch: int, compute_dtype: str, conv_channels=(32, 64)) -> float:
    """The larger of the step's FLOPs over the peak for its type and its
    bytes over the memory rate."""
    return max(step_flops(model, batch, conv_channels) / PEAK_FLOPS_PER_S[compute_dtype],
               step_bytes(model, batch, conv_channels) / HBM_BYTES_PER_S)
