"""Loss terms of the associative VAE objective (counterpart of vae_assoc_tpu/ops/losses.py).

    cost = Σ_k mean_batch[ recon_k + KL_k ] + λ · Σ_{i<j} mean_batch ‖μ_i − μ_j‖²

per-sample terms, summed over feature or latent dimensions:

    recon_bernoulli = −Σ_d [ x log(x̂ + ε) + (1−x) log(1−x̂ + ε) ],  ε = 1e-10
    recon_gaussian  = Σ_d (x − x̂)²
    KL              = −½ Σ_z (1 + logσ² − μ² − σ²)

The Bernoulli term has two forms: ``parity_mode=True`` is the reference's
sigmoid-then-clamped-log math; the default is the stable logit-space
cross-entropy ``max(l,0) − l·x + log1p(exp(−|l|))``.

``ordered=True`` (implied by parity mode) sums in a strict left-to-right
order with a loop of fp32 adds, so the transcendental-free terms (Gaussian
recon, the L2 association forms) are bit-identical to the numpy oracle's
``np.cumsum`` (tests/oracle_np.py); ``ordered_mean`` multiplies by the fp32
reciprocal of the length, as the JAX package does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from vae_assoc_tpu_torch.configs import ASSOC_FORMS
from vae_assoc_tpu_torch.ops.collectives import gather_rows_summed_grad

_EPS = 1e-10  # reference's log-clamp epsilon


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def ordered_sum(x, axis: int = -1) -> torch.Tensor:
    """Sum along ``axis`` with a pinned strict left-to-right order: one fp32
    add per element, in sequence (torch.cumsum may accumulate wider)."""
    x = torch.movedim(_f32(x), axis, 0)
    out = x[0]
    for i in range(1, x.shape[0]):
        out = out + x[i]
    return out


def ordered_mean(x, axis: int = -1) -> torch.Tensor:
    """`ordered_sum` times the fp32 reciprocal of the length."""
    x = _f32(x)
    return ordered_sum(x, axis) * torch.tensor(1.0 / x.shape[axis], dtype=torch.float32)


def _sum(x, *, ordered: bool, axis: int = -1):
    return ordered_sum(x, axis) if ordered else torch.sum(x, dim=axis)


def bernoulli_recon(x, *, logits=None, probs=None, parity_mode: bool = False):
    """Per-sample Bernoulli reconstruction loss, summed over features, [batch].

    Pass ``logits`` (pre-sigmoid decoder output, preferred) or ``probs``."""
    x = _f32(x)
    if parity_mode or logits is None:
        if probs is None:
            probs = torch.sigmoid(_f32(logits))
        probs = _f32(probs)
        ll = x * torch.log(_EPS + probs) + (1.0 - x) * torch.log(_EPS + 1.0 - probs)
        return -_sum(ll, ordered=parity_mode)
    l = _f32(logits)
    ce = torch.clamp_min(l, 0.0) - l * x + torch.log1p(torch.exp(-torch.abs(l)))
    return torch.sum(ce, dim=-1)


def gaussian_recon(x, x_recon, *, ordered: bool = False):
    """Per-sample squared error (linear decoder), [batch]."""
    d = _f32(x) - _f32(x_recon)
    return _sum(d * d, ordered=ordered)


def kl_divergence(z_mean, z_logvar, *, ordered: bool = False):
    """Per-sample KL(N(μ, σ²) ‖ N(0, I)), summed over latent dims, [batch]."""
    mu = _f32(z_mean)
    lv = _f32(z_logvar)
    return -0.5 * _sum(1.0 + lv - mu * mu - torch.exp(lv), ordered=ordered)


def assoc_loss(z_means, *, z_logvars=None, zs=None, form: str = "mean_l2",
               temp: float = 0.1, ordered: bool = False,
               negatives: str = "local", gather_group=None, keys=None):
    """Cross-modal latent-association term, [batch], summed over pairs i<j.

    - ``"mean_l2"``: ‖μ_i − μ_j‖².
    - ``"sample_l2"``: ‖z_i − z_j‖² on the sampled latents ``zs``.
    - ``"sym_kl"``: KL(p_i‖p_j) + KL(p_j‖p_i) between the diagonal
      Gaussians, ½ Σ_d [(σ_i² + Δμ²)/σ_j² + (σ_j² + Δμ²)/σ_i² − 2].
    - ``"infonce"``: symmetric CLIP-style contrastive loss on the
      L2-normalized means at temperature ``temp``, the rest of the batch as
      negatives. With ``negatives="global"`` and a data-parallel
      ``gather_group`` (the process group whose ranks hold the other rows
      of the global batch), the normalized means are all-gathered over the
      group, so every rank contrasts against the global batch and the
      objective does not depend on the number of ranks; the gather's
      backward sums the ranks' cotangents, as JAX's ``all_gather``
      transposes. Without a group (one device) global and local are the
      same set. ``keys`` (global negatives only): each modality's means
      of the global batch, gathered by the caller, in place of the gather
      (the sweep's data-parallel step gathers its stacked means outside
      ``vmap``, where a collective can run, and carries their cotangent
      back itself).
    """
    if form not in ASSOC_FORMS:
        raise ValueError(f"unknown assoc_form {form!r}; one of {ASSOC_FORMS}")
    if form == "infonce":
        return _infonce(z_means, temp, negatives=negatives, gather_group=gather_group,
                        keys=keys)
    if form == "sample_l2":
        if zs is None:
            raise ValueError("assoc_form='sample_l2' needs zs (sampled latents)")
        pts = [_f32(z) for z in zs]
    else:
        pts = [_f32(z) for z in z_means]
    total = torch.zeros(pts[0].shape[0], dtype=torch.float32, device=pts[0].device)
    if len(pts) < 2:
        return total
    if form == "sym_kl":
        if z_logvars is None:
            raise ValueError("assoc_form='sym_kl' needs z_logvars")
        lvs = [_f32(v) for v in z_logvars]
        for i in range(len(pts)):
            for j in range(i + 1, len(pts)):
                d2 = torch.square(pts[i] - pts[j])
                vi, vj = torch.exp(lvs[i]), torch.exp(lvs[j])
                term = 0.5 * ((vi + d2) / vj + (vj + d2) / vi - 2.0)
                total = total + _sum(term, ordered=ordered)
        return total
    for i in range(len(pts)):
        for j in range(i + 1, len(pts)):
            d = pts[i] - pts[j]
            total = total + _sum(d * d, ordered=ordered)
    return total


INFONCE_STREAM_MIN_B = 8192
"""Negative-set size from which the logsumexp streams over column blocks
instead of materializing the [B, B] logit matrix (1 GB per pair and
direction at B = 16384)."""

INFONCE_BLOCK = 1024


def _lse_block(a, blk, inv_t, m, s):
    logits = (a @ blk.T) * inv_t
    new_m = torch.maximum(m, logits.max(dim=1).values)
    s = s * torch.exp(m - new_m) + torch.exp(logits - new_m[:, None]).sum(dim=1)
    return new_m, s


def _lse_rows_streamed(a, bmat, inv_t, blk: int):
    """logsumexp over axis 1 of ``(a @ bmat.T) * inv_t`` in column blocks of
    ``blk`` rows of ``bmat``, carrying a running (max, scaled sum). The last
    block holds the remainder, so any size streams. Each block's logits are
    recomputed in the backward (activation checkpointing), so the matrix
    never materializes in either pass."""
    m = torch.full((a.shape[0],), -torch.inf, dtype=torch.float32, device=a.device)
    s = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for start in range(0, bmat.shape[0], blk):
        block = bmat[start:start + blk]
        if torch.is_grad_enabled() and (a.requires_grad or bmat.requires_grad):
            m, s = checkpoint(_lse_block, a, block, inv_t, m, s, use_reentrant=False)
        else:
            m, s = _lse_block(a, block, inv_t, m, s)
    return m + torch.log(s)


def _lse_rows(a, bmat, inv_t):
    """logsumexp over axis 1 of ``(a @ bmat.T) * inv_t``; streamed from
    ``INFONCE_STREAM_MIN_B`` negatives up, whatever their count."""
    if bmat.shape[0] >= INFONCE_STREAM_MIN_B:
        return _lse_rows_streamed(a, bmat, inv_t, INFONCE_BLOCK)
    return torch.logsumexp((a @ bmat.T) * inv_t, dim=1)


def _normalize(z):
    return z * torch.rsqrt(torch.sum(z * z, dim=-1, keepdim=True) + 1e-12)


def _infonce(z_means, temp: float, *, negatives: str = "local", gather_group=None,
             keys=None):
    """Per-sample symmetric InfoNCE over all modality pairs, [batch]."""
    if temp <= 0:
        raise ValueError(f"infonce temperature must be > 0, got {temp}")
    if negatives not in ("local", "global"):
        raise ValueError(
            f"infonce negatives must be 'local' or 'global', got {negatives!r}"
        )
    zs = [_f32(z) for z in z_means]
    b = zs[0].shape[0]
    total = torch.zeros(b, dtype=torch.float32, device=zs[0].device)
    if len(zs) < 2:
        return total
    inv_t = 1.0 / temp
    normed = [_normalize(z) for z in zs]
    gathered = normed
    if negatives == "global" and keys is not None:
        gathered = [_normalize(_f32(k)) for k in keys]
    elif negatives == "global" and gather_group is not None:
        gathered = [gather_rows_summed_grad(z, gather_group) for z in normed]
    for i in range(len(zs)):
        for j in range(i + 1, len(zs)):
            # The positive is the matched local pair, which the gathered
            # negative set holds too, as the softmax denominator needs.
            pos = torch.sum(normed[i] * normed[j], dim=-1) * inv_t
            ce_row = _lse_rows(normed[i], gathered[j], inv_t) - pos
            ce_col = _lse_rows(normed[j], gathered[i], inv_t) - pos
            total = total + 0.5 * (ce_row + ce_col)
    return total
