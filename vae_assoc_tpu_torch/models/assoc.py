"""Joint associative multi-modal VAE (counterpart of vae_assoc_tpu/models/assoc.py).

K per-modality VAEs trained under one objective,

    cost = Σ_k mean[recon_k + KL_k] + λ · Σ_{i<j} mean ‖μ_i − μ_j‖²

(`assoc_loss_fn`), sharing one latent space. Cross-modal generation encodes
with modality i's recognition net and decodes with modality j's generator
net (`cross_generate`): image→trajectory writes a character that was only
seen; trajectory→image renders what a motion looks like.

Params: an :class:`AssocVAE` module holding one tower pair per modality in
``modalities``, so its state_dict keys (``modalities.0.recog.h1.w``) mirror
the JAX tree ``{"modalities": (params_0, ..., params_{K-1})}``.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vae_assoc_tpu_torch.configs import AssocConfig, gener_widths, recog_widths
from vae_assoc_tpu_torch.models import vae as vae_mod
from vae_assoc_tpu_torch.ops import losses
from vae_assoc_tpu_torch.ops.sampling import fold_in

class AssocVAE(nn.Module):
    """One tower pair per modality: a
    :class:`~vae_assoc_tpu_torch.models.networks.MLPVAE`, or a
    :class:`~vae_assoc_tpu_torch.models.conv.ConvVAE` for a conv encoder.
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


def modality_seeds(seed, k: int) -> list:
    """One ε seed per modality: folded from the step's ``seed``, an int; or,
    where ``seed`` is an int64 tensor [k] of seeds folded already (the
    step's values in device memory, train/step.py::StepScalars), its
    entries as 0-dim tensors."""
    if isinstance(seed, torch.Tensor):
        if seed.shape != (k,):
            raise ValueError(f"expected {k} modality seeds, got shape {tuple(seed.shape)}")
        return list(seed.unbind())
    return [fold_in(seed, i) for i in range(k)]


def assoc_forward(params: AssocVAE, xs, cfg: AssocConfig, *, seed=None, eps=None,
                  compute_dtype="float32", use_pallas=False, cond=None,
                  remat: bool = False):
    """Run all K modality VAEs; ε per modality from ``seed`` (one modality
    seed each, ``modality_seeds``) or the ``eps`` list.

    ``remat=True`` recomputes each tower in the backward instead of keeping
    its activations (activation checkpointing); the recompute replays the
    same ε (the same injected tensor, or the same seed)."""
    xs, cond = split_cond(xs, cfg, cond)
    k = len(cfg.modalities)
    seeds = [None] * k
    if eps is None:
        if seed is None:
            raise ValueError("assoc_forward needs `seed` or `eps`")
        seeds, eps = modality_seeds(seed, k), [None] * k

    def fwd(p, x, m, s, e):
        def f(x, e):
            return vae_mod.vae_forward(p, x, m, seed=s, eps=e, compute_dtype=compute_dtype,
                                       use_pallas=use_pallas, cond=cond)

        return checkpoint(f, x, e, use_reentrant=False) if remat else f(x, e)

    return tuple(fwd(p, x, m, s, e) for p, x, m, s, e
                 in zip(params.modalities, xs, cfg.modalities, seeds, eps))


class MegaFallbackWarning(UserWarning):
    """``use_pallas="mega"`` fell back to the composable kernels for a config
    the tower megakernel does not implement. Its own category, so a process
    that runs with warnings as errors can allow exactly this notice."""


def mega_fallback_reason(cfg: AssocConfig):
    """Why ``use_pallas="mega"`` cannot run this config on the tower
    megakernel, or None when it can. The reasons are the math the kernel
    implements (a depth-2 softplus MLP tower, ε surfaced for sample-coupled
    forms); the reference's VMEM capacity reason has no counterpart, since
    the Hopper kernels size their row tiles to shared memory themselves."""
    if cfg.assoc_form == "sample_l2" and any(
        m.encoder in ("conv", "conv_pallas") for m in cfg.modalities
    ):
        return (
            "assoc_form='sample_l2' couples the sampled z and a conv "
            "modality's tower does not surface its ε draw"
        )
    for m in cfg.modalities:
        if m.is_sketch:
            return f"modality {m.name!r} is a sketch_rnn tower"
        if m.transfer != "softplus":
            return f"modality {m.name!r} uses transfer={m.transfer!r}"
        if m.encoder == "mlp" and (
            len(recog_widths(m.arch)) != 2 or len(gener_widths(m.arch)) != 2
        ):
            return f"modality {m.name!r} has a non-depth-2 arch dict"
    return None


def assoc_loss_fn(params: AssocVAE, xs, cfg: AssocConfig, *, seed=None, eps=None,
                  compute_dtype="float32", parity_mode: bool = False,
                  use_pallas=False, cond=None, remat: bool = False, data_group=None):
    """Joint objective → (total, metrics dict): total, ``recon_<m>``,
    ``kl_<m>`` per modality, and ``assoc``.

    ``use_pallas``: False is the plain torch path (autograd through the
    towers and losses; the oracle of the others). True is the composable
    kernel path: the fused encoder, sampler and decoder kernels per tower
    and one fused loss kernel over all modalities, each an autograd
    Function whose backward is a kernel, so input gradients are true ones.
    "mega" runs each tower in the megakernel (kernels/megakernel.py; a conv
    tower in kernels/conv_mega.py, on the kernels for encoder="conv_pallas"
    and on plain torch convs for "conv"), differentiable with respect to
    the weights only; a config it does not
    implement (``mega_fallback_reason``) warns ``MegaFallbackWarning`` and
    runs the composable path, as the reference does. ``parity_mode`` keeps
    the ordered plain losses on every path; with a kernel path it runs the
    kernel towers under them. ``remat`` recomputes each tower in the
    backward; the megakernel recomputes its decoder anyway. ``data_group``:
    the data-parallel process group whose ranks hold the other rows of the
    global batch, where this runs inside a data-parallel step; InfoNCE with
    ``assoc_negatives="global"`` gathers its negatives over it."""
    xs, cond = split_cond(xs, cfg, cond)
    if use_pallas == "mega" and not parity_mode:
        reason = mega_fallback_reason(cfg)
        if reason is None:
            return _assoc_loss_mega(params, xs, cfg, seed=seed, eps=eps,
                                    compute_dtype=compute_dtype, cond=cond,
                                    data_group=data_group)
        warnings.warn(
            f"use_pallas='mega' fell back to the composable kernels: {reason}. The "
            "step still runs the fused kernels, but not the single-launch tower "
            "megakernel.",
            MegaFallbackWarning,
            stacklevel=2,
        )
        use_pallas = True
    outs = assoc_forward(params, xs, cfg, seed=seed, eps=eps, compute_dtype=compute_dtype,
                         use_pallas=use_pallas, cond=cond, remat=remat)
    return joint_objective(outs, xs, cfg, use_pallas=use_pallas, parity_mode=parity_mode,
                           data_group=data_group)


def joint_objective(outs, xs, cfg: AssocConfig, *, use_pallas=False,
                    parity_mode: bool = False, data_group=None):
    """(total, metrics) of the joint objective from the towers' forward
    outputs ``outs`` on the inputs ``xs``: on the fused loss kernel where
    ``use_pallas`` (and not ``parity_mode``), else the plain losses. A
    sketch modality adds its L_R and kl_weight·max(KL, kl_tolerance)
    (models/sketch_rnn.py), computed with its tower."""
    terms = {}
    dense = [i for i, m in enumerate(cfg.modalities) if not m.is_sketch]
    is_mean_l2 = cfg.assoc_form == "mean_l2"
    fused_assoc = is_mean_l2 and len(dense) == len(cfg.modalities)
    col_means = None
    if use_pallas and not parity_mode and dense:
        # One fused pass over every dense modality's loss terms
        # (kernels/loss.py). Its association column is the mean-L2 form
        # over all modalities; another form, or a sketch modality, couples
        # through ops/losses on the tensors already at hand.
        from vae_assoc_tpu_torch.kernels.loss import joint_loss_terms_fused

        k = len(dense)
        fused = joint_loss_terms_fused(
            [cfg.modalities[i].recon for i in dense], [xs[i] for i in dense],
            [outs[i].recon for i in dense], [outs[i].z_mean for i in dense],
            [outs[i].z_logvar for i in dense], with_assoc=fused_assoc,
        )
        col_means = fused.mean(0)
        for j, i in enumerate(dense):
            terms[i] = {"recon": col_means[j], "kl": col_means[k + j]}
    for i, (m, x, out) in enumerate(zip(cfg.modalities, xs, outs)):
        if i not in terms:
            terms[i] = vae_mod.vae_loss(out, x, m, parity_mode=parity_mode)
    metrics = {}
    total = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    for i, m in enumerate(cfg.modalities):
        metrics[f"recon_{m.name}"] = terms[i]["recon"]
        metrics[f"kl_{m.name}"] = terms[i]["kl"]
        kl = terms[i]["kl"] * m.kl_weight if m.is_sketch else terms[i]["kl"]
        total = total + terms[i]["recon"] + kl
    if col_means is not None and fused_assoc:
        assoc = col_means[2 * len(dense)]
    elif use_pallas and not parity_mode:
        assoc = torch.mean(_assoc_per_sample(outs, cfg, data_group=data_group))
    else:
        mean = losses.ordered_mean if parity_mode else torch.mean
        assoc = mean(_assoc_per_sample(outs, cfg, ordered=parity_mode,
                                       data_group=data_group))
    metrics["assoc"] = assoc
    total = total + cfg.assoc_lambda * assoc
    metrics["total"] = total
    return total, metrics


def _assoc_per_sample(outs, cfg: AssocConfig, *, ordered: bool = False,
                      data_group=None):
    """Per-sample association term in the configured form, from the
    per-modality forward outputs (ops/losses.assoc_loss does the math)."""
    return losses.assoc_loss(
        [o.z_mean for o in outs], z_logvars=[o.z_logvar for o in outs],
        zs=[o.z for o in outs], form=cfg.assoc_form, temp=cfg.assoc_temp,
        ordered=ordered, negatives=cfg.assoc_negatives, gather_group=data_group,
    )


def _assoc_loss_mega(params, xs, cfg, *, seed=None, eps=None, compute_dtype, cond=None,
                     data_group=None):
    """Joint objective through one tower megakernel per modality, plus the
    small association term in torch on the surfaced μ, logσ² (and ε)."""
    from vae_assoc_tpu_torch.kernels.megakernel import vae_tower_fused

    k = len(cfg.modalities)
    if len(xs) != k:
        raise ValueError(f"expected {k} modality inputs, got {len(xs)}")
    if eps is None:
        if seed is None:
            raise ValueError("assoc_loss_fn needs `seed` or `eps`")
        seeds, eps = modality_seeds(seed, k), [None] * k
    else:
        seeds = [None] * k
    metrics = {}
    total = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    mus, lvs, zs = [], [], []
    for p, x, m, s, e in zip(params.modalities, xs, cfg.modalities, seeds, eps):
        vae_mod._check_width(x, m.arch["n_input"], m.name, "input")
        if m.encoder in ("conv", "conv_pallas"):
            # The encoder field picks the conv tower, as the reference's:
            # "conv" the plain torch convs, "conv_pallas" the conv-tower
            # megakernel (kernels/conv_mega.py).
            from vae_assoc_tpu_torch.kernels import conv_mega

            tower = (conv_mega.conv_tower_fused if m.encoder == "conv_pallas"
                     else conv_mega.conv_tower_xla)
            out = tower(p, x, kind=m.recon, seed=s, eps=e, compute_dtype=compute_dtype)
        else:
            out = vae_tower_fused(
                p, x, kind=m.recon, seed=s, eps=e, compute_dtype=compute_dtype,
                cond=vae_mod.prepare_cond(cond, m, x.shape[0], device=x.device),
            )
        metrics[f"recon_{m.name}"] = torch.mean(out["recon_term"])
        metrics[f"kl_{m.name}"] = torch.mean(out["kl_term"])
        total = total + metrics[f"recon_{m.name}"] + metrics[f"kl_{m.name}"]
        mus.append(out["mu"])
        lvs.append(out["lv"])
        if cfg.assoc_form == "sample_l2":
            zs.append(out["mu"] + torch.exp(0.5 * out["lv"]) * out["eps"])
    assoc = torch.mean(losses.assoc_loss(
        mus, z_logvars=lvs, zs=zs or None, form=cfg.assoc_form,
        temp=cfg.assoc_temp, negatives=cfg.assoc_negatives, gather_group=data_group,
    ))
    metrics["assoc"] = assoc
    total = total + cfg.assoc_lambda * assoc
    metrics["total"] = total
    return total, metrics


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
