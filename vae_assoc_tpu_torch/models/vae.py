"""Single-modality VAE (counterpart of vae_assoc_tpu/models/vae.py).

``vae_forward`` runs encoder → reparameterized sample → decoder and
``vae_loss`` adds the per-modality objective (training); ``transform`` runs
the recognition net to the latent mean and ``generate`` the generator net
with its output activation (serving). A conditional modality concatenates
its condition to the encoder input and to z at the call boundary, so the
fused kernels run unchanged on the widened first layers. A sketch modality
(``encoder="sketch_rnn"``) runs Sketch-RNN's tower (models/sketch_rnn.py)
behind the same verbs: its ``generate`` is the greedy decode.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vae_assoc_tpu_torch.configs import TRANSFER_FNS, ModalityConfig
from vae_assoc_tpu_torch.models import networks
from vae_assoc_tpu_torch.ops import losses, sampling


class VAEOutputs(NamedTuple):
    z_mean: torch.Tensor  # [B, n_z] fp32
    z_logvar: torch.Tensor  # [B, n_z] fp32
    z: torch.Tensor  # [B, n_z] sampled latent
    recon: torch.Tensor  # [B, n_input] decoder pre-activation (logits / linear)


def _net_fns(cfg: ModalityConfig, use_pallas=False):
    """Resolve (init, encode, decode) for the modality's tower.

    ``use_pallas`` (kept under its JAX name) selects the fused CUDA MLP
    kernels. They implement softplus only; other transfers run the plain
    torch path. A conv tower takes its ops from the encoder field alone, as
    the reference does: ``"conv"`` the plain torch convs, ``"conv_pallas"``
    the conv kernels (kernels/conv.py) whatever ``use_pallas`` says."""
    if use_pallas and cfg.transfer != "softplus":
        use_pallas = False
    if cfg.encoder in ("conv", "conv_pallas"):
        from vae_assoc_tpu_torch.models import conv as conv_mod

        if cfg.encoder == "conv_pallas":
            from vae_assoc_tpu_torch.kernels import conv as kconv

            return (conv_mod.init_conv_vae_params, kconv.encode_conv_fused,
                    kconv.decode_conv_fused)
        return conv_mod.init_conv_vae_params, conv_mod.encode_conv, conv_mod.decode_conv
    if use_pallas:
        from vae_assoc_tpu_torch.kernels import mlp as kmlp

        return networks.init_mlp_vae_params, kmlp.encode_mlp_fused, kmlp.decode_mlp_fused
    return networks.init_mlp_vae_params, networks.encode_mlp, networks.decode_mlp


def init_vae(generator: torch.Generator | None, cfg: ModalityConfig, *, device):
    """One modality's towers; zeros when ``generator`` is None."""
    if cfg.is_sketch:
        from vae_assoc_tpu_torch.models.sketch_rnn import SketchRNN

        return SketchRNN(cfg.arch, device=device, generator=generator)
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
    """z → x̂ in data space (decoder only; sigmoid for Bernoulli modalities;
    a sketch modality's greedy decode, [B, max_seq_len, 5])."""
    _check_width(z, cfg.arch["n_z"], cfg.name, "latent")
    if cfg.is_sketch:
        from vae_assoc_tpu_torch.models import sketch_rnn

        return sketch_rnn.greedy_decode(params, z, cfg, compute_dtype=compute_dtype,
                                        use_pallas=use_pallas)
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
    if cfg.is_sketch:
        from vae_assoc_tpu_torch.models import sketch_rnn

        return sketch_rnn.transform(params, x, cfg, compute_dtype=compute_dtype,
                                    use_pallas=use_pallas)
    _check_width(x, cfg.arch["n_input"], cfg.name, "input")
    cond = prepare_cond(cond, cfg, x.shape[0], device=x.device)
    if cond is not None:
        x = torch.cat([x.float(), cond], dim=1)
    _, encode, _ = _net_fns(cfg, use_pallas)
    z_mean, _ = encode(
        params, x, compute_dtype=compute_dtype, transfer=TRANSFER_FNS[cfg.transfer]
    )
    return z_mean


def draw_eps(seed, batch: int, cfg: ModalityConfig, device) -> torch.Tensor:
    """The modality's ε [batch, n_z] for ``seed`` (an int or a 0-dim int64
    tensor, ops/sampling.philox_normal): the counter-based stream
    that the tower kernel draws in place (ops/sampling.philox_normal), so the
    plain and the kernel path see the same noise for the same seed."""
    return sampling.philox_normal(seed, batch, cfg.arch["n_z"], device)


def vae_forward(params, x, cfg: ModalityConfig, *, seed=None, eps=None,
                compute_dtype="float32", use_pallas=False, cond=None) -> VAEOutputs:
    """Encoder → reparameterized sample → decoder. ε from ``seed`` or explicit.

    ``use_pallas`` runs the fused CUDA towers and, for a seed, the fused
    sampler kernel (softplus only, as the reference). ``cond``: the
    condition of a conditional modality, concatenated to the encoder input
    and to the sampled latent. A sketch modality's ``recon`` is its scalar
    reconstruction loss (models/sketch_rnn.py::sketch_forward)."""
    if cfg.is_sketch:
        from vae_assoc_tpu_torch.models import sketch_rnn

        return sketch_rnn.sketch_forward(params, x, cfg, seed=seed, eps=eps,
                                         compute_dtype=compute_dtype, use_pallas=use_pallas)
    _check_width(x, cfg.arch["n_input"], cfg.name, "input")
    cond = prepare_cond(cond, cfg, x.shape[0], device=x.device)
    _, encode, decode = _net_fns(cfg, use_pallas)
    transfer = TRANSFER_FNS[cfg.transfer]
    x_in = x if cond is None else torch.cat([x.float(), cond], dim=1)
    z_mean, z_logvar = encode(params, x_in, compute_dtype=compute_dtype, transfer=transfer)
    if eps is None and seed is None:
        raise ValueError("vae_forward needs `seed` or `eps`")
    if use_pallas and eps is None and cfg.transfer == "softplus":
        # The fused sampler kernel draws the same ε as draw_eps(seed).
        from vae_assoc_tpu_torch.kernels.sampling import reparameterize_fused

        z = reparameterize_fused(z_mean, z_logvar, seed)
    else:
        if eps is None:
            eps = draw_eps(seed, x.shape[0], cfg, x.device)
        z = sampling.reparameterize(z_mean, z_logvar, eps=eps)
    z_in = z if cond is None else torch.cat([z, cond], dim=1)
    recon = decode(params, z_in, compute_dtype=compute_dtype, transfer=transfer)
    return VAEOutputs(z_mean, z_logvar, z, recon)


def vae_loss(out: VAEOutputs, x, cfg: ModalityConfig, *, parity_mode: bool = False):
    """Per-modality loss terms, each a mean-over-batch fp32 scalar:
    dict(recon=..., kl=...). In parity mode every reduction runs in the
    pinned left-to-right order of the numpy oracle. A sketch modality's are
    L_R and max(KL, kl_tolerance)."""
    if cfg.is_sketch:
        from vae_assoc_tpu_torch.models import sketch_rnn

        return {"recon": out.recon, "kl": sketch_rnn.kl_term(out, cfg)}
    if cfg.recon == "bernoulli":
        recon = losses.bernoulli_recon(x, logits=out.recon, parity_mode=parity_mode)
    else:
        recon = losses.gaussian_recon(x, out.recon, ordered=parity_mode)
    kl = losses.kl_divergence(out.z_mean, out.z_logvar, ordered=parity_mode)
    mean = losses.ordered_mean if parity_mode else torch.mean
    return {"recon": mean(recon), "kl": mean(kl)}


def reconstruct(params, x, cfg: ModalityConfig, *, seed=None, eps=None,
                compute_dtype="float32", cond=None):
    """x → x̂ in data space through a sampled z (sigmoid for Bernoulli)."""
    out = vae_forward(params, x, cfg, seed=seed, eps=eps,
                      compute_dtype=compute_dtype, cond=cond)
    if cfg.recon == "bernoulli":
        return torch.sigmoid(out.recon)
    return out.recon
