"""Arc-length trajectory resampling on the device (counterpart of vae_assoc_tpu/ops/resample.py).

Variable-length pen strokes arrive padded to a static ``[B, max_pts, 2]``
with their lengths; resampling is a batched cumsum / searchsorted / gather /
lerp with no data-dependent shapes.
"""

from __future__ import annotations

import torch


def batch_resample(points: torch.Tensor, lengths: torch.Tensor, num_samples: int):
    """[B, max_pts, D] + [B] lengths → [B, num_samples, D], uniform in arc length.

    Padding past each length is clamped to the last valid point, so padded
    segments have length 0. Degenerate inputs (length 1 or zero total arc
    length) collapse to a constant polyline at the first point."""
    pts_in = points.float()
    b, n, dim = pts_in.shape
    idx = torch.minimum(
        torch.arange(n, device=pts_in.device)[None, :], lengths.long()[:, None] - 1
    )
    pts = torch.gather(pts_in, 1, idx[:, :, None].expand(b, n, dim))
    seg = pts[:, 1:] - pts[:, :-1]
    seg_len = torch.sqrt(torch.sum(seg * seg, dim=-1))  # [B, n-1]
    cum = torch.cat(
        [torch.zeros(b, 1, dtype=torch.float32, device=pts.device),
         torch.cumsum(seg_len, dim=1)], dim=1)
    total = cum[:, -1:]
    t = torch.linspace(0.0, 1.0, num_samples, device=pts.device)[None, :] * torch.clamp_min(total, 1e-12)
    sidx = torch.clamp(torch.searchsorted(cum, t, right=True) - 1, 0, n - 2)
    d0 = torch.gather(cum, 1, sidx)
    sl = torch.gather(seg_len, 1, sidx)
    frac = torch.where(sl > 0, (t - d0) / torch.clamp_min(sl, 1e-12), torch.zeros_like(t))
    gi = sidx[:, :, None].expand(b, num_samples, dim)
    p0 = torch.gather(pts, 1, gi)
    p1 = torch.gather(pts, 1, gi + 1)
    return p0 + frac[:, :, None] * (p1 - p0)


def normalize_and_flatten(points: torch.Tensor, lengths: torch.Tensor,
                          num_samples: int, *, flatten: bool = True):
    """Resample → center on the bounding-box midpoint → scale the larger box
    side to [-1, 1] (aspect kept) → flatten to [B, num_samples·D]
    (x0, y0, x1, y1, ...) or keep [B, num_samples, D]."""
    traj = batch_resample(points, lengths, num_samples)
    lo = traj.amin(dim=1, keepdim=True)
    hi = traj.amax(dim=1, keepdim=True)
    center = 0.5 * (lo + hi)
    half_span = (hi - lo).amax(dim=-1, keepdim=True) * 0.5
    traj = (traj - center) / torch.clamp_min(half_span, 1e-6)
    if flatten:
        return traj.reshape(traj.shape[0], -1)
    return traj
