"""Sketch-RNN's mixture loss and its gradient in one pass (``csrc/mixture.cu``), and its twin.

Each row of the head's output y [rows, 3 + 6M] against its target
(Δx, Δy, p1, p2, p3): pen logits y[0:3]; then six groups of M, π
(softmax), μx, μy, σx = exp, σy = exp, ρ = tanh; the row's loss is

    −log(Σ_j π_j N(Δx, Δy | μ_j, σ_j, ρ_j) + 1e-6)·(1 − p3)
        + CE(pen logits, (p1, p2, p3))

(sketch_rnn ``model.py::get_lossfunc``, training mode). The kernel writes
the loss of every row and its gradient with respect to y, and the autograd
backward scales that gradient by the cotangent of each row's loss. A CUDA
tensor launches the kernel (counted as ``mixture_loss`` in
``_launches.TRAINING``) or raises; a CPU tensor runs the twin.
"""

from __future__ import annotations

import math

import torch

from vae_assoc_tpu_torch.kernels import _build, _launches
from vae_assoc_tpu_torch.kernels import mlp as kmlp

EPS = 1e-6


def components(width: int) -> int:
    """M of a head output 3 + 6M wide."""
    m, rem = divmod(width - 3, 6)
    if rem or m < 1:
        raise ValueError(f"a mixture head is 3 + 6M wide, got {width}")
    return m


def mixture_loss_plain(y: torch.Tensor, tgt: torch.Tensor):
    """Plain twin of the kernel: (loss [rows], dy [rows, 3 + 6M]), the same
    formulas in the same order."""
    m = components(y.shape[1])
    y, tgt = y.float(), tgt.float()
    x1, x2, mask = tgt[:, 0:1], tgt[:, 1:2], 1.0 - tgt[:, 4]
    a, mu1, mu2, s1h, s2h, rh = y[:, 3:].split(m, dim=1)
    ea = torch.exp(a - a.amax(1, keepdim=True))
    pi = ea / ea.sum(1, keepdim=True)
    s1, s2, rho = torch.exp(s1h), torch.exp(s2h), torch.tanh(rh)
    n1, n2 = (x1 - mu1) / s1, (x2 - mu2) / s2
    q = 1.0 - rho * rho
    z = n1 * n1 + n2 * n2 - 2.0 * rho * n1 * n2
    nj = torch.exp(-z / (2.0 * q)) / (2.0 * math.pi * (s1 * s2) * torch.sqrt(q))
    pn = pi * nj
    s = pn.sum(1)
    logit = y[:, :3]
    lmax = logit.amax(1, keepdim=True)
    el = torch.exp(logit - lmax)
    esum = el.sum(1, keepdim=True)
    p = tgt[:, 2:5]
    ce = (-p * (logit - lmax - torch.log(esum))).sum(1)
    loss = -torch.log(s + EPS) * mask + ce
    coef = (-mask / (s + EPS))[:, None]
    w = coef * pn
    dy = torch.cat([el / esum * p.sum(1, keepdim=True) - p, coef * (pn - pi * s[:, None]),
                    w * (n1 - rho * n2) / (q * s1), w * (n2 - rho * n1) / (q * s2),
                    w * ((n1 * n1 - rho * n1 * n2) / q - 1.0),
                    w * ((n2 * n2 - rho * n1 * n2) / q - 1.0),
                    w * (n1 * n2 - z * rho / q + rho)], dim=1)
    return loss, dy


def mixture_loss_kernel(y: torch.Tensor, tgt: torch.Tensor):
    """(loss, dy): the kernel on a CUDA tensor, its twin on the CPU."""
    if y.device.type == "cpu":
        return mixture_loss_plain(y, tgt)
    if y.device.type != "cuda":
        raise ValueError(f"the mixture-loss kernel runs on CUDA, got {y.device}")
    y, tgt = y.detach().float().contiguous(), tgt.detach().float().contiguous()
    rows, width = y.shape
    m = components(width)
    if m > 32:
        raise ValueError(f"the mixture-loss kernel takes at most 32 components, got {m}")
    kmlp._check_f32(tgt, y.device, "target", (rows, 5))
    loss = torch.empty(rows, dtype=torch.float32, device=y.device)
    dy = torch.empty_like(y)
    if rows:
        lib = _build.load()
        with torch.cuda.device(y.device):
            err = lib.vae_mixture_loss(y.data_ptr(), tgt.data_ptr(), rows, m, loss.data_ptr(),
                                       dy.data_ptr(), kmlp._stream(y))
        _build.check(lib, err, "mixture_loss kernel launch")
        _launches.count(_launches.TRAINING, "mixture_loss")
    return loss, dy


class _MixtureLoss(torch.autograd.Function):
    """The per-row loss of y against the target; differentiable in y."""

    @staticmethod
    def forward(ctx, y, tgt):
        loss, dy = mixture_loss_kernel(y, tgt)
        ctx.save_for_backward(dy)
        return loss

    @staticmethod
    def backward(ctx, g):
        (dy,) = ctx.saved_tensors
        return dy * g[:, None], None


def mixture_loss(y: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Each row's loss [rows] of the head output y [rows, 3 + 6M] against
    the target stroke-5 points [rows, 5]."""
    return _MixtureLoss.apply(y, tgt)
