"""Stroke rasterization on the device (counterpart of vae_assoc_tpu/ops/rasterize.py).

Trajectory → 28×28 image in [0, 1]: bilinear point splatting, a separable
Gaussian blur as two small matrix products, and max-normalization.

The JAX package splats by scatter-add. On CUDA, ``index_add_`` adds with
atomics, so points landing on one pixel sum in a varying order and the
same strokes give other last bits from run to run. A bilinear splat is
separable, so here it is one batched product of each point's row weights
and column weights, [B, size, T] · [B, T, size], which sums in a fixed
order.
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
    b = traj.shape[0]
    dev = traj.device
    margin = 1.5
    scale = (size - 1 - 2 * margin) / 2.0
    px = margin + (traj[..., 0] + 1.0) * scale
    py = margin + (1.0 - traj[..., 1]) * scale
    grid = torch.arange(size, device=dev)

    def axis_weights(p):
        """[B, T] coordinates → [B, T, size]: each point's weight on its two
        neighbouring rows (or columns), clamped to the grid."""
        p0 = torch.floor(p)
        f = (p - p0)[..., None]
        p0 = p0.long()[..., None]
        lo = torch.clamp(p0, 0, size - 1) == grid
        hi = torch.clamp(p0 + 1, 0, size - 1) == grid
        return (1 - f) * lo + f * hi

    img = torch.bmm(axis_weights(py).transpose(1, 2), axis_weights(px))

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
