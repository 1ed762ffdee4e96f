"""Stroke augmentation on the device (counterpart of vae_assoc_tpu/ops/augment.py).

Per-sample random affine maps of the RAW stroke points, before either
modality is derived, so the rasterized image and the trajectory features
of a pair see the same deformed geometry. The normalizer centers each
curve and rescales it isotropically, so translation and uniform scale
would cancel; what reaches the model is:

- rotation            θ ~ U(−max_rotate°, +max_rotate°)
- shear (x by y)      s ~ U(−max_shear, +max_shear)
- anisotropic scale   a ~ U(1−max_scale, 1+max_scale) on x relative to y
- point jitter        ε ~ N(0, (point_jitter · extent)²) per point, with
  extent the larger side of each sample's bounding box over its valid
  points, so tablet coordinates and unit-box strokes jitter alike.

The draws (:func:`augment_strokes`) are split from the arithmetic
(:func:`apply_augment`): ``torch.Generator`` streams cannot match
``jax.random``'s, so parity with the JAX package injects its draws.
Padded rows past ``lengths`` are transformed too, harmlessly: every
consumer masks by length.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Knobs of :func:`augment_strokes`; 0 turns a transform off.
    ``max_rotate`` is in degrees."""

    max_rotate: float = 15.0
    max_shear: float = 0.15
    max_scale: float = 0.15
    point_jitter: float = 0.01

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v < 0:
                raise ValueError(f"{f.name} must be >= 0, got {v}")
        if not self.max_scale < 1.0:
            raise ValueError(
                f"max_scale must be < 1 (scale factor 1±max), got {self.max_scale}"
            )


def apply_augment(points, lengths, u_rot, u_shear, u_scale, noise, cfg: AugmentConfig):
    """[B, P, 2] strokes → transformed [B, P, 2], fp32, from given draws:
    ``u_rot``, ``u_shear``, ``u_scale`` [B] uniform in [-1, 1) and
    ``noise`` [B, P, 2] standard normal (unused, and may be None, when
    ``cfg.point_jitter`` is 0)."""
    pts = points.float()
    theta = math.radians(cfg.max_rotate) * u_rot
    shear = cfg.max_shear * u_shear
    scale = 1.0 + cfg.max_scale * u_scale
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)

    def mat(m00, m01, m10, m11):  # [B, 2, 2] from four [B] entries
        return torch.stack([torch.stack([m00, m01], -1), torch.stack([m10, m11], -1)], -2)

    # A = R(θ) · Shear(s) · Scale(a, 1); rows transform as p' = p · Aᵀ.
    a = mat(c, -s, s, c) @ mat(one, shear, zero, one) @ mat(scale, zero, zero, one)
    out = torch.einsum("bpd,bed->bpe", pts, a)
    if cfg.point_jitter > 0:
        p = pts.shape[1]
        mask = (torch.arange(p, device=pts.device)[None, :] < lengths[:, None])[..., None]
        big = torch.tensor(1e30, dtype=torch.float32, device=pts.device)
        lo = torch.where(mask, pts, big).amin(dim=1, keepdim=True)
        hi = torch.where(mask, pts, -big).amax(dim=1, keepdim=True)
        extent = torch.clamp_min((hi - lo).amax(dim=-1, keepdim=True), 1e-6)
        out = out + cfg.point_jitter * extent * noise
    return out


def augment_strokes(points, lengths, generator: torch.Generator,
                    cfg: AugmentConfig = AugmentConfig()):
    """[B, P, 2] raw strokes → randomly transformed [B, P, 2], on the
    strokes' device. Draws rotation, shear, scale and jitter from
    ``generator`` (on that device), in that order; the same generator
    state gives the same bits."""
    b = points.shape[0]
    dev = points.device

    def uniform():
        return torch.rand(b, generator=generator, device=dev) * 2.0 - 1.0

    u_rot, u_shear, u_scale = uniform(), uniform(), uniform()
    noise = None
    if cfg.point_jitter > 0:
        noise = torch.randn(points.shape, generator=generator, device=dev)
    return apply_augment(points, lengths, u_rot, u_shear, u_scale, noise, cfg)
