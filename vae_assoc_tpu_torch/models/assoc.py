"""Joint associative multi-modal VAE: the serving half of vae_assoc_tpu/models/assoc.py.

K per-modality VAEs share one latent space. Cross-modal generation encodes
with modality i's recognition net and decodes with modality j's generator
net (`cross_generate`): image→trajectory writes a character that was only
seen; trajectory→image renders what a motion looks like.

Params: an :class:`AssocVAE` module holding one tower pair per modality in
``modalities``, so its state_dict keys (``modalities.0.recog.h1.w``) mirror
the JAX tree ``{"modalities": (params_0, ..., params_{K-1})}``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vae_assoc_tpu_torch.configs import AssocConfig
from vae_assoc_tpu_torch.models import vae as vae_mod


class AssocVAE(nn.Module):
    """One :class:`~vae_assoc_tpu_torch.models.networks.MLPVAE` per modality.
    Without a generator the weights are zeros, to be loaded."""

    def __init__(self, cfg: AssocConfig, *, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.modalities = nn.ModuleList(
            vae_mod.init_vae(generator, m, device=device) for m in cfg.modalities
        )


def init_assoc(seed: int, cfg: AssocConfig, *, device) -> AssocVAE:
    """Xavier-initialized joint model. The weights are drawn on the CPU from
    a torch.Generator seeded with ``seed``, so they do not depend on the
    device."""
    gen = torch.Generator().manual_seed(int(seed))
    return AssocVAE(cfg, device=device, generator=gen)


def split_cond(xs: Sequence, cfg: AssocConfig, cond=None):
    """Separate the condition input from a batch list.

    Conditional models carry the shared condition as ONE extra trailing
    entry, ``[x_0, ..., x_{K-1}, cond]``, or as the ``cond`` kwarg when the
    list has exactly K entries. Returns ``(xs[:K], cond)``."""
    k = len(cfg.modalities)
    if cfg.n_cond > 0:
        if len(xs) == k + 1:
            if cond is not None:
                raise ValueError(
                    "condition passed both as xs[-1] and as the cond kwarg"
                )
            return list(xs[:k]), xs[k]
        if len(xs) == k and cond is not None:
            return list(xs), cond
        raise ValueError(
            f"conditional model (n_cond={cfg.n_cond}): pass the condition "
            f"as a trailing batch entry ([x_0..x_{k-1}, cond]) or the "
            f"cond kwarg; got {len(xs)} entries and cond={cond is not None}"
        )
    if len(xs) != k:
        raise ValueError(f"expected {k} modality inputs, got {len(xs)}")
    if cond is not None:
        raise ValueError("model is unconditional (n_cond=0) but cond given")
    return list(xs), None


def transform(params: AssocVAE, xs, cfg: AssocConfig, *, compute_dtype="float32",
              use_pallas=False, cond=None):
    """Per-modality latent means: [x_0..x_{K-1}] → (μ_0..μ_{K-1})."""
    xs, cond = split_cond(xs, cfg, cond)
    return tuple(
        vae_mod.transform(
            p, x, m, compute_dtype=compute_dtype, use_pallas=use_pallas, cond=cond
        )
        for p, x, m in zip(params.modalities, xs, cfg.modalities)
    )


def generate(params: AssocVAE, z, cfg: AssocConfig, modality, *,
             compute_dtype="float32", use_pallas=False, cond=None):
    """Decode latent z with one modality's generator net."""
    i = cfg.modality_index(modality)
    return vae_mod.generate(
        params.modalities[i], z, cfg.modalities[i],
        compute_dtype=compute_dtype, use_pallas=use_pallas, cond=cond,
    )


def cross_generate(params: AssocVAE, x, cfg: AssocConfig, src, dst, *,
                   compute_dtype="float32", use_pallas=False, cond=None):
    """Encode with modality `src`, decode with modality `dst`. Conditional
    models thread the same condition through both nets."""
    i = cfg.modality_index(src)
    z = vae_mod.transform(
        params.modalities[i], x, cfg.modalities[i],
        compute_dtype=compute_dtype, use_pallas=use_pallas, cond=cond,
    )
    return generate(
        params, z, cfg, dst,
        compute_dtype=compute_dtype, use_pallas=use_pallas, cond=cond,
    )
