"""Single-modality VAE: the serving half of vae_assoc_tpu/models/vae.py.

``transform`` runs the recognition net to the latent mean; ``generate`` runs
the generator net and applies the output activation. A conditional modality
concatenates its condition to the encoder input and to z at the call
boundary, so the fused kernels run unchanged on the widened first layers.
The sampler, the forward pass with ε and the losses belong to training, a
later port item.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vae_assoc_tpu_torch.configs import TRANSFER_FNS, ModalityConfig
from vae_assoc_tpu_torch.models import networks


def _net_fns(cfg: ModalityConfig, use_pallas=False):
    """Resolve (init, encode, decode) for the modality's tower.

    ``use_pallas`` (kept under its JAX name) selects the fused CUDA MLP
    kernels. They implement softplus only; other transfers run the plain
    torch path."""
    if use_pallas and cfg.transfer != "softplus":
        use_pallas = False
    if cfg.encoder != "mlp":
        raise NotImplementedError(
            f"modality {cfg.name!r}: encoder={cfg.encoder!r} towers are not "
            "ported yet; the port runs encoder='mlp'"
        )
    if use_pallas:
        from vae_assoc_tpu_torch.kernels import mlp as kmlp

        return networks.init_mlp_vae_params, kmlp.encode_mlp_fused, kmlp.decode_mlp_fused
    return networks.init_mlp_vae_params, networks.encode_mlp, networks.decode_mlp


def init_vae(generator: torch.Generator | None, cfg: ModalityConfig, *, device):
    """One modality's towers; zeros when ``generator`` is None."""
    init_fn, _, _ = _net_fns(cfg)
    return init_fn(generator, cfg.arch, device=device, n_cond=cfg.n_cond)


def prepare_cond(cond, cfg: ModalityConfig, batch: int, *, device=None):
    """Validate/convert the condition input for a conditional modality.

    Accepts integer class labels ``[B]`` (one-hot encoded here) or a float
    ``[B, n_cond]`` (one-hot or soft). Returns the fp32 ``[B, n_cond]``
    tensor to concatenate, or None for an unconditional modality.
    """
    if cfg.n_cond == 0:
        if cond is not None:
            raise ValueError(
                f"modality {cfg.name!r} is unconditional (n_cond=0) but a "
                "condition input was given"
            )
        return None
    if cond is None:
        raise ValueError(
            f"modality {cfg.name!r} is conditional (n_cond={cfg.n_cond}); "
            "pass `cond` (int labels [B] or one-hot [B, n_cond])"
        )
    cond = torch.as_tensor(cond, device=device)
    if cond.ndim == 1:
        cond = F.one_hot(cond.long(), cfg.n_cond)
    if cond.ndim != 2 or cond.shape[-1] != cfg.n_cond:
        raise ValueError(
            f"cond must be [B] int labels or [B, {cfg.n_cond}]; "
            f"got shape {tuple(cond.shape)}"
        )
    if cond.shape[0] != batch:
        raise ValueError(f"cond batch {cond.shape[0]} != input batch {batch}")
    return cond.float()


def _check_width(t, n: int, name: str, what: str):
    """A request of the wrong width is the caller's error: ValueError."""
    if t.ndim != 2 or t.shape[1] != n:
        raise ValueError(
            f"modality {name!r} expects a [batch, {n}] {what}, got "
            f"{tuple(t.shape)}"
        )


def generate(params, z, cfg: ModalityConfig, *, compute_dtype="float32",
             use_pallas=False, cond=None):
    """z → x̂ in data space (decoder only; sigmoid for Bernoulli modalities)."""
    _check_width(z, cfg.arch["n_z"], cfg.name, "latent")
    cond = prepare_cond(cond, cfg, z.shape[0], device=z.device)
    if cond is not None:
        z = torch.cat([z.float(), cond], dim=1)
    _, _, decode = _net_fns(cfg, use_pallas)
    recon = decode(
        params, z, compute_dtype=compute_dtype, transfer=TRANSFER_FNS[cfg.transfer]
    )
    if cfg.recon == "bernoulli":
        return torch.sigmoid(recon)
    return recon


def transform(params, x, cfg: ModalityConfig, *, compute_dtype="float32",
              use_pallas=False, cond=None):
    """x → z_mean (the reference's `transform`: recognition-net mean)."""
    _check_width(x, cfg.arch["n_input"], cfg.name, "input")
    cond = prepare_cond(cond, cfg, x.shape[0], device=x.device)
    if cond is not None:
        x = torch.cat([x.float(), cond], dim=1)
    _, encode, _ = _net_fns(cfg, use_pallas)
    z_mean, _ = encode(
        params, x, compute_dtype=compute_dtype, transfer=TRANSFER_FNS[cfg.transfer]
    )
    return z_mean
