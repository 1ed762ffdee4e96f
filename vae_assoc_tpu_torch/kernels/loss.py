"""The fused joint loss: hand-written CUDA kernels and their plain twins.

Counterpart of vae_assoc_tpu/kernels/loss.py. ``joint_loss_terms_fused``
computes every per-sample term of the joint objective for all K
modalities in one launch of ``csrc/loss.cu::loss_fwd`` (replacing the
Pallas ``_loss_kernel``), as a [B, 2K+1] matrix: recon_0..K (Bernoulli
logit cross-entropy or Gaussian squared error, summed over features),
kl_0..K, and the mean-L2 association term Σ_{i<j}‖μ_i − μ_j‖²
(``with_assoc=False`` drops that column: [B, 2K]). It is a
``torch.autograd.Function`` whose backward is one launch of
``loss.cu::loss_bwd`` (replacing the Pallas ``_loss_bwd_kernel``): the
closed-form drecon, dμ and dlogσ². The gradient with respect to the data x
is derived outside the kernel, in torch, and only when x requires grad.

The means over the batch and the λ-weighted total stay with the caller
(models/assoc.py). Dispatch is by the device of the input, and only by
it: a CPU tensor goes to the plain twins; a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from vae_assoc_tpu_torch.kernels import _build, _launches
from vae_assoc_tpu_torch.kernels import mlp as kmlp

KINDS = ("bernoulli", "gaussian")
MAX_MODALITIES = 8
"""Modalities the kernels' by-value table holds (``kMaxMods`` in csrc/loss.cu)."""


def _ncols(k: int, with_assoc: bool) -> int:
    return 2 * k + int(with_assoc)


def loss_terms_plain(kinds, xs, recons, mus, lvs, with_assoc=True):
    """Plain twin of the forward kernel: the per-sample matrix [B, 2K(+1)],
    written as the reference kernel's formulas (loss.py::_loss_kernel)."""
    cols = []
    for kind, x, r in zip(kinds, xs, recons):
        if kind == "bernoulli":
            ce = torch.clamp_min(r, 0.0) - r * x + torch.log1p(torch.exp(-torch.abs(r)))
            cols.append(ce.sum(-1))
        else:
            d = x - r
            cols.append((d * d).sum(-1))
    for mu, lv in zip(mus, lvs):
        cols.append(-0.5 * (1.0 + lv - mu * mu - torch.exp(lv)).sum(-1))
    if with_assoc:
        assoc = torch.zeros_like(cols[0])
        for i in range(len(mus)):
            for j in range(i + 1, len(mus)):
                d = mus[i] - mus[j]
                assoc = assoc + (d * d).sum(-1)
        cols.append(assoc)
    return torch.stack(cols, dim=-1)


def loss_terms_bwd_plain(kinds, g, xs, recons, mus, lvs, with_assoc=True):
    """Plain twin of the backward kernel: (drecons, dmus, dlvs), each a list
    over the modalities, from the cotangent g [B, 2K(+1)] of the per-sample
    matrix (loss.py::_loss_bwd_kernel)."""
    k = len(kinds)
    drecons, dmus, dlvs = [], [], []
    for i, (kind, x, r) in enumerate(zip(kinds, xs, recons)):
        g_rec = g[:, i:i + 1]
        if kind == "bernoulli":
            drecons.append((torch.sigmoid(r) - x) * g_rec)
        else:
            drecons.append(2.0 * (r - x) * g_rec)
    for i in range(k):
        g_kl = g[:, k + i:k + i + 1]
        mu, lv = mus[i], lvs[i]
        dmu = mu * g_kl
        if with_assoc:
            g_as = g[:, 2 * k:2 * k + 1]
            for j in range(k):
                if j != i:
                    dmu = dmu + 2.0 * (mu - mus[j]) * g_as
        dmus.append(dmu)
        dlvs.append(0.5 * (torch.exp(lv) - 1.0) * g_kl)
    return drecons, dmus, dlvs


def _table(kinds, xs, recons, mus, lvs, outs=None):
    """The kernels' by-value modality table: 9 int64 values per modality
    (x, r, μ, logσ², drecon, dμ, dlogσ², width, Bernoulli flag)."""
    rows = []
    for i, kind in enumerate(kinds):
        back = [0, 0, 0] if outs is None else [t[i].data_ptr() for t in outs]
        rows += [xs[i].data_ptr(), recons[i].data_ptr(), mus[i].data_ptr(),
                 lvs[i].data_ptr(), *back, xs[i].shape[1], int(kind == "bernoulli")]
    return (ctypes.c_longlong * len(rows))(*rows)


def _check(kinds, xs, recons, mus, lvs):
    """Validate the modality lists for a launch; returns (device, batch, n_z)."""
    k = len(kinds)
    if not 1 <= k <= MAX_MODALITIES:
        raise ValueError(f"the loss kernels take 1 to {MAX_MODALITIES} modalities, got {k}")
    if any(kind not in KINDS for kind in kinds):
        raise ValueError(f"kinds must be in {KINDS}, got {kinds}")
    if not len(xs) == len(recons) == len(mus) == len(lvs) == k:
        raise ValueError("xs, recons, mus and lvs need one entry per modality")
    dev = xs[0].device
    batch, n_z = mus[0].shape
    for i in range(k):
        kmlp._check_f32(xs[i], dev, f"x[{i}]")
        kmlp._check_f32(recons[i], dev, f"recon[{i}]", xs[i].shape)
        kmlp._check_f32(mus[i], dev, f"mu[{i}]", (batch, n_z))
        kmlp._check_f32(lvs[i], dev, f"logvar[{i}]", (batch, n_z))
        if xs[i].shape[0] != batch:
            raise ValueError(f"x[{i}] has {xs[i].shape[0]} rows, expected {batch}")
    return dev, batch, n_z


def _f32(ts):
    return [t.detach().float().contiguous() for t in ts]


def loss_terms(kinds, xs, recons, mus, lvs, with_assoc=True):
    """The per-sample matrix: the forward kernel on a CUDA tensor, its twin
    on the CPU."""
    xs, recons, mus, lvs = (_f32(ts) for ts in (xs, recons, mus, lvs))
    if xs[0].device.type == "cpu":
        return loss_terms_plain(kinds, xs, recons, mus, lvs, with_assoc)
    if xs[0].device.type != "cuda":
        raise ValueError(f"the loss kernel runs on CUDA, got {xs[0].device}")
    dev, batch, n_z = _check(kinds, xs, recons, mus, lvs)
    out = torch.empty(batch, _ncols(len(kinds), with_assoc), dtype=torch.float32, device=dev)
    if batch:
        lib = _build.load()
        with torch.cuda.device(dev):
            err = lib.vae_loss_fwd(_table(kinds, xs, recons, mus, lvs), len(kinds), batch,
                                   n_z, int(with_assoc), out.data_ptr(), kmlp._stream(out))
        _build.check(lib, err, "loss kernel launch")
        _launches.count(_launches.TRAINING, "loss_fwd")
    return out


def loss_terms_bwd(kinds, g, xs, recons, mus, lvs, with_assoc=True):
    """(drecons, dmus, dlvs): the backward kernel on a CUDA tensor, its twin
    on the CPU."""
    xs, recons, mus, lvs = (_f32(ts) for ts in (xs, recons, mus, lvs))
    g = g.detach().float().contiguous()
    if g.device.type == "cpu":
        return loss_terms_bwd_plain(kinds, g, xs, recons, mus, lvs, with_assoc)
    if g.device.type != "cuda":
        raise ValueError(f"the loss-backward kernel runs on CUDA, got {g.device}")
    dev, batch, n_z = _check(kinds, xs, recons, mus, lvs)
    kmlp._check_f32(g, dev, "g", (batch, _ncols(len(kinds), with_assoc)))
    outs = ([torch.empty_like(r) for r in recons], [torch.empty_like(m) for m in mus],
            [torch.empty_like(v) for v in lvs])
    if batch:
        lib = _build.load()
        with torch.cuda.device(dev):
            err = lib.vae_loss_bwd(_table(kinds, xs, recons, mus, lvs, outs), len(kinds),
                                   batch, n_z, int(with_assoc), g.data_ptr(), kmlp._stream(g))
        _build.check(lib, err, "loss-backward kernel launch")
        _launches.count(_launches.TRAINING, "loss_bwd")
    return outs


class _JointLoss(torch.autograd.Function):
    """Inputs: kinds, with_assoc, then xs, recons, μs, logσ²s (K each)."""

    @staticmethod
    def forward(ctx, kinds, with_assoc, *tensors):
        k = len(kinds)
        parts = [tensors[i * k:(i + 1) * k] for i in range(4)]
        ctx.kinds, ctx.with_assoc = kinds, with_assoc
        ctx.save_for_backward(*tensors)
        return loss_terms(kinds, *parts, with_assoc=with_assoc)

    @staticmethod
    def backward(ctx, g):
        kinds, k = ctx.kinds, len(ctx.kinds)
        saved = ctx.saved_tensors
        xs, recons, mus, lvs = ([t.float() for t in saved[i * k:(i + 1) * k]]
                                for i in range(4))
        drecons, dmus, dlvs = loss_terms_bwd(kinds, g, xs, recons, mus, lvs,
                                             with_assoc=ctx.with_assoc)
        # dL/dx, closed form and elementwise, outside the kernel: training
        # never asks for it; a caller optimizing the inputs gets the true one.
        dxs = []
        for i, kind in enumerate(kinds):
            if not ctx.needs_input_grad[2 + i]:
                dxs.append(None)
                continue
            g_rec = g[:, i:i + 1].float()
            dxs.append(-recons[i] * g_rec if kind == "bernoulli"
                       else 2.0 * (xs[i] - recons[i]) * g_rec)
        return (None, None, *dxs, *drecons, *dmus, *dlvs)


def joint_loss_terms_fused(kinds, xs, recons, mus, lvs, with_assoc=True):
    """Per-sample loss matrix [B, 2K+1]: recon_0..K, kl_0..K, assoc.

    ``kinds``: "bernoulli" or "gaussian" per modality; ``xs``/``recons``:
    per-modality [B, D_k]; ``mus``/``lvs``: per-modality [B, n_z].
    ``with_assoc=False`` drops the mean-L2 association column and its
    backward term, returning [B, 2K]: the caller couples the modalities
    through another association form, computed outside the kernel."""
    kinds = tuple(kinds)
    return _JointLoss.apply(kinds, bool(with_assoc), *xs, *recons, *mus, *lvs)
