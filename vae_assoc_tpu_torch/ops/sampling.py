"""Reparameterization sampler: z = μ + σ·ε, ε ~ N(0, I).

Counterpart of vae_assoc_tpu/ops/sampling.py. ``sample_eps`` draws from a
``torch.Generator``; ``philox_normal`` is the counter-based stream the
training step uses: ε at (row, column) is a pure function of a 64-bit seed
and that position, computed with the same integers by the tower kernel
(kernels/csrc/common.cuh::philox_normal) and here in torch. A seed is a
Python int, or its 64 bits held as a 0-dim int64 tensor (``seed_bits``),
which a captured training step reads from device memory. The JAX
package's draws (jax.random, the TPU's on-core PRNG) are other streams, so
parity tests inject ε on both sides.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def sample_eps(generator: torch.Generator | None, shape, device) -> torch.Tensor:
    """Draw ε ~ N(0, I) from ``generator`` (the default one when None)."""
    if generator is None:
        return torch.randn(shape, device=device)
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def reparameterize(z_mean, z_logvar, *, generator=None, eps=None) -> torch.Tensor:
    """z = μ + sqrt(exp(logσ²))·ε. Pass a ``generator`` or an explicit ``eps``."""
    if eps is None:
        if generator is None:
            raise ValueError("reparameterize needs `generator` or `eps`")
        eps = sample_eps(generator, z_mean.shape, z_mean.device)
    eps = eps.float()
    return z_mean.float() + torch.sqrt(torch.exp(z_logvar.float())) * eps


def fold_in(seed: int, data: int) -> int:
    """A new 64-bit seed from ``seed`` and ``data`` (SplitMix64's finalizer):
    the per-step and per-modality seeds of the ε stream."""
    z = (seed ^ ((data + 1) * 0x9E3779B97F4A7C15)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def seed_bits(seed: int) -> int:
    """The 64 bits of ``seed`` as a signed int64 value, as an int64 tensor
    holds them: a seed of 2**63 or more reads negative, with the same bits."""
    seed &= _MASK64
    return seed - (1 << 64) if seed >> 63 else seed


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a·b for a 32-bit constant and int64 words b,
    in 16-bit halves so that no product leaves int64."""
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (hh + (lh >> 16) + (hl >> 16) + (mid >> 16)) & _MASK32
    return hi, lo


def philox_normal(seed, rows: int, cols: int, device, row0: int = 0) -> torch.Tensor:
    """ε [rows, cols] fp32 for rows row0.. of the stream keyed by ``seed``,
    an int or a 0-dim int64 tensor of its bits (the same draw).

    Philox4x32-10 with key (seed low word, seed high word) and counter
    (row, column, 0, 0), then the reference's Box–Muller on the first two
    output words (vae_assoc_tpu/kernels/sampling.py::_normal_bits): 24 high
    bits each, u1 kept off zero by 1e-7."""
    if isinstance(seed, torch.Tensor):
        k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    else:
        seed &= _MASK64
        k0, k1 = seed & _MASK32, seed >> 32
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    c0, c1 = torch.broadcast_tensors(r[:, None], c[None, :])
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    u1 = (c0 >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-7
    u2 = (c1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.283185307179586 * u2)
