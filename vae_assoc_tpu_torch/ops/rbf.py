"""RBF trajectory encoding on the device (counterpart of vae_assoc_tpu/ops/rbf.py).

A trajectory becomes the K·D weights of Y(t) ≈ Φ(t)·W with Gaussian bases
Φ over normalized time, fitted by ridge least squares. Φ is shared by the
batch, so the fit is one Cholesky of the [K, K] Gram matrix and one solve
of all B·D right-hand sides together:

    W* = (ΦᵀΦ + λI)⁻¹ Φᵀ Y

The Gram matrix is ill-conditioned in fp32 (about 4e6 for 100 bases over
100 steps), so two solvers' weights may differ in their leading digits
while both reconstruct the curve to fp32 precision: compare
reconstructions, not weights.
"""

from __future__ import annotations

import torch

from vae_assoc_tpu_torch.models.networks import cuda_or_raise


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``num`` fp32 points from start to stop, rounded as the JAX package's
    jitted ``jnp.linspace`` rounds them: with r = fp32(1 / (num − 1)),
    start·(1 − i·r) + i·(stop·r). torch.linspace rounds some points one
    ulp apart, and a basis of σ ≈ 0.009 turns that into 8e-6."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32, device=device)
    f32 = torch.float32
    r = torch.tensor(1.0, dtype=f32) / (num - 1)
    i = torch.arange(num - 1, dtype=f32, device=device)
    a, b = torch.tensor(start, dtype=f32), torch.tensor(stop, dtype=f32)
    head = a.to(device) * (1 - i * r.to(device)) + i * (b * r).to(device)
    return torch.cat([head, b.reshape(1).to(device)])


def rbf_basis(n_timesteps: int, n_centers: int, width: float | None = None, *,
              device="cuda") -> torch.Tensor:
    """[T, K] Gaussian bases over normalized time, fp32, on ``device`` (the
    card unless the caller names the CPU).

    Centers extend 10 % beyond [0, 1], so the endpoints sit inside the
    bases' support; σ defaults to 0.75× the center spacing."""
    device = cuda_or_raise(device, "rbf_basis")
    ext = 0.1
    t = _linspace(0.0, 1.0, n_timesteps, device)[:, None]
    c = _linspace(-ext, 1.0 + ext, n_centers, device)[None, :]
    sigma = width if width is not None else (1 + 2 * ext) * 0.75 / max(n_centers - 1, 1)
    return torch.exp(-0.5 * ((t - c) / sigma) ** 2)


def fit_rbf(traj: torch.Tensor, n_centers: int = 20, lam: float = 1e-6) -> torch.Tensor:
    """[B, T, D] trajectories → [B, K·D] weights (k-major, d-minor), fp32,
    on the trajectories' device."""
    b, t, d = traj.shape
    phi = rbf_basis(t, n_centers, device=traj.device)
    gram = phi.T @ phi + lam * torch.eye(n_centers, device=traj.device)
    rhs = torch.einsum("tk,btd->kbd", phi, traj.float()).reshape(n_centers, b * d)
    w = torch.cholesky_solve(rhs, torch.linalg.cholesky(gram))
    return w.reshape(n_centers, b, d).permute(1, 0, 2).reshape(b, n_centers * d)


def rbf_reconstruct(weights: torch.Tensor, n_timesteps: int, n_dims: int = 2) -> torch.Tensor:
    """[B, K·D] weights → [B, T, D] trajectories (decode the encoding)."""
    b = weights.shape[0]
    k = weights.shape[1] // n_dims
    phi = rbf_basis(n_timesteps, k, device=weights.device)
    return torch.einsum("tk,bkd->btd", phi, weights.float().reshape(b, k, n_dims))
