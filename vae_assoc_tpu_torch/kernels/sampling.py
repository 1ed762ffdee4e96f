"""The fused reparameterization sampler: a hand-written CUDA kernel and its plain twin.

Counterpart of vae_assoc_tpu/kernels/sampling.py. ``reparameterize_fused``
draws ε on the chip and returns z = μ + e^{½logσ²}·ε in one launch of
``csrc/sampling.cu::reparam`` (replacing the Pallas ``_reparam_kernel``).
ε is the counter-based Philox stream of ``ops/sampling.philox_normal``,
indexed by (row, column) and keyed by the modality seed, so for one seed
the plain path, the tower megakernel and this sampler draw the same noise
(the TPU kernel hashes its tile index into the seed instead, a stream of
its own). The seed is an int, passed to the kernel by value, or a 0-dim
int64 tensor on the device, which the kernel reads through its pointer
when it runs: a captured training step (train/loop.py) draws each replay's
ε from the seed written there before the replay. The backward is the
reference's ``_reparam_bwd``, elementwise torch on the saved ε: dμ = g,
dlogσ² = ½·g·e^{½logσ²}·ε.

Dispatch is by the device of the input, and only by it: a CPU tensor goes
to the plain twin; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from vae_assoc_tpu_torch.kernels import _build, _launches
from vae_assoc_tpu_torch.kernels import mlp as kmlp
from vae_assoc_tpu_torch.ops.sampling import philox_normal

_MASK64 = (1 << 64) - 1


def seed_arg(seed, device) -> tuple:
    """(pointer, value) of a seed as the seeded kernels take it: a 0-dim
    int64 tensor on ``device`` by its pointer (the value then unused), an
    int by value with a null pointer."""
    if isinstance(seed, torch.Tensor):
        if seed.shape != () or seed.dtype != torch.int64 or seed.device != device:
            raise ValueError(f"a seed tensor is a 0-dim int64 tensor on {device}, got "
                             f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
        return seed.data_ptr(), 0
    return None, int(seed) & _MASK64


def reparameterize_plain(z_mean, z_logvar, seed):
    """Plain twin of the sampler kernel: (z, ε) with ε =
    ``philox_normal(seed)`` and z = μ + e^{½logσ²}·ε."""
    mu, lv = z_mean.float(), z_logvar.float()
    eps = philox_normal(seed, mu.shape[0], mu.shape[1], mu.device)
    return mu + torch.exp(0.5 * lv) * eps, eps


def reparameterize_kernel(z_mean, z_logvar, seed):
    """(z, ε): the sampler kernel on a CUDA tensor, its twin on the CPU."""
    if z_mean.device.type == "cpu":
        return reparameterize_plain(z_mean, z_logvar, seed)
    if z_mean.device.type != "cuda":
        raise ValueError(f"the sampler kernel runs on CUDA, got {z_mean.device}")
    dev = z_mean.device
    mu, lv = (t.detach().float().contiguous() for t in (z_mean, z_logvar))
    if mu.ndim != 2:
        raise ValueError(f"expected [batch, n_z] means, got {tuple(mu.shape)}")
    kmlp._check_f32(lv, dev, "z_logvar", mu.shape)
    seed_at, seed = seed_arg(seed, dev)
    z, eps = torch.empty_like(mu), torch.empty_like(mu)
    if mu.numel():
        lib = _build.load()
        with torch.cuda.device(dev):
            err = lib.vae_reparam(mu.data_ptr(), lv.data_ptr(), mu.shape[0], mu.shape[1],
                                  seed_at, seed, z.data_ptr(), eps.data_ptr(),
                                  kmlp._stream(mu))
        _build.check(lib, err, "sampler kernel launch")
        _launches.count(_launches.TRAINING, "reparam")
    return z, eps


class _Reparam(torch.autograd.Function):
    """z = μ + e^{½logσ²}·ε with ε drawn from the seed; the backward is the
    reference's _reparam_bwd on the saved ε."""

    @staticmethod
    def forward(ctx, seed, z_mean, z_logvar):
        z, eps = reparameterize_kernel(z_mean, z_logvar, seed)
        ctx.save_for_backward(z_logvar, eps)
        return z

    @staticmethod
    def backward(ctx, g):
        lv, eps = ctx.saved_tensors
        return None, g, 0.5 * g * torch.exp(0.5 * lv.float()) * eps


def reparameterize_fused(z_mean, z_logvar, seed) -> torch.Tensor:
    """z [B, n_z] = μ + e^{½logσ²}·ε, ε drawn on the device from ``seed``
    (the modality seed, models/assoc.modality_seeds: an int or a 0-dim
    int64 tensor). A replay with the same seed (activation checkpointing)
    draws the same ε."""
    return _Reparam.apply(seed if isinstance(seed, torch.Tensor) else int(seed),
                          z_mean, z_logvar)
