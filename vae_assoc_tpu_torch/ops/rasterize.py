"""Stroke rasterization on the device (counterpart of vae_assoc_tpu/ops/rasterize.py).

Trajectory → 28×28 image in [0, 1]: bilinear point splatting by scatter-add,
a separable Gaussian blur as two small matrix products, and
max-normalization.
"""

from __future__ import annotations

import torch


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def rasterize_trajectories(traj: torch.Tensor, size: int = 28, sigma: float = 0.7):
    """[B, T, 2] trajectories in [-1, 1]² → [B, size·size] images in [0, 1].

    Each point adds to its 4 neighbouring pixels bilinearly; y is drawn
    downward (row 0 = top)."""
    traj = traj.float()
    b, t, _ = traj.shape
    dev = traj.device
    margin = 1.5
    scale = (size - 1 - 2 * margin) / 2.0
    px = margin + (traj[..., 0] + 1.0) * scale
    py = margin + (1.0 - traj[..., 1]) * scale
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    fx = px - x0
    fy = py - y0
    img = torch.zeros(b * size * size, dtype=torch.float32, device=dev)
    base = (torch.arange(b, device=dev) * (size * size))[:, None]
    for dy, dx, w in (
        (0, 0, (1 - fy) * (1 - fx)),
        (0, 1, (1 - fy) * fx),
        (1, 0, fy * (1 - fx)),
        (1, 1, fy * fx),
    ):
        yy = torch.clamp(y0 + dy, 0, size - 1)
        xx = torch.clamp(x0 + dx, 0, size - 1)
        img.index_add_(0, (base + yy * size + xx).reshape(-1), w.reshape(-1))
    img = img.reshape(b, size, size)

    radius = max(1, int(3 * sigma))
    k = _gaussian_kernel1d(sigma, radius, dev)
    blur = torch.zeros(size, size, dtype=torch.float32, device=dev)
    rows = torch.arange(size, device=dev)
    for i, off in enumerate(range(-radius, radius + 1)):
        cols = torch.clamp(rows + off, 0, size - 1)
        blur.index_put_((rows, cols), k[i].expand(size), accumulate=True)
    img = torch.einsum("brc,kr->bkc", img, blur)
    img = torch.einsum("brc,kc->brk", img, blur)

    peak = img.amax(dim=(1, 2), keepdim=True)
    img = torch.clamp(img / torch.clamp_min(peak, 1e-6), 0.0, 1.0)
    return img.reshape(b, size * size)
