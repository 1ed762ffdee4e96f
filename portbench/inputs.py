"""Inputs and weights from the run's seed, made on the run's device in a few large calls.

Images (Bernoulli modalities): each row has its own ink share, drawn
from U(0.05, 0.5); an inked pixel takes one of the levels 64/255 … 1.
Trajectories (Gaussian modalities): a pen walk of n_input / 2 points in
two dimensions, steps N(0, 0.1²), flattened (x0, y0, x1, y1, …). Rows
differ in how much ink they carry, as characters do, so a batch mean
over half the rows differs from the whole batch's.
"""

from __future__ import annotations

import torch

from portbench.reference import model as ref

DATA, WEIGHTS = 1, 2  # what a sub-seed is for


def sub_seed(seed: int, what: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    return ref.fold_in(int(seed), what) >> 1


def generator(seed: int, what: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, what))
    return g


def make_pairs(model: dict, n: int, seed: int, device) -> list:
    """One [n, n_input] float32 tensor per modality of ``model``."""
    g = generator(seed, DATA, device)
    out = []
    for m in model["modalities"]:
        d = int(m["arch"]["n_input"])
        if m["recon"] == "bernoulli":
            ink = torch.rand(n, 1, generator=g, device=device) * 0.45 + 0.05
            u = torch.rand(n, 2, d, generator=g, device=device)
            level = torch.floor(u[:, 1] * 192.0 + 64.0) / 255.0
            out.append(torch.where(u[:, 0] < ink, level, torch.zeros((), device=device)))
        else:
            steps = torch.randn(n, d // 2, 2, generator=g, device=device) * 0.1
            out.append(torch.cumsum(steps, dim=1).reshape(n, d))
    return out


def make_weights(model: dict, seed: int, device, conv_channels=(32, 64)) -> dict:
    """Glorot-uniform weights and zero biases by the program's parameter names."""
    return ref.init_params(ref.param_spec(model, conv_channels), generator(seed, WEIGHTS, device))

