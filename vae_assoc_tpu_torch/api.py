"""Public API with the reference's class surface (counterpart of vae_assoc_tpu/api.py).

``VariationalAutoencoder`` (one modality) and ``AssocVariationalAutoEncoder``
(K modalities) keep the verb set ``partial_fit / transform / generate /
reconstruct / cross_generate`` and ``save_model / restore_model / load``,
with the JAX package's constructor knobs. Inside they are the port's
functional core: the state is an explicit
:class:`~vae_assoc_tpu_torch.train.step.TrainState` on the model's device
(the card unless the constructor names the CPU), each step is the port's
train step, and the verbs run ``models/assoc.py`` with the train config's
``compute_dtype`` and ``use_pallas``. Verbs return torch tensors on the
model's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from vae_assoc_tpu_torch import bucketing
from vae_assoc_tpu_torch.configs import (
    AssocConfig, ModalityConfig, TrainConfig, config_from_dict, config_to_dict,
)
from vae_assoc_tpu_torch.models import assoc as assoc_mod
from vae_assoc_tpu_torch.models import vae as vae_mod
from vae_assoc_tpu_torch.models.networks import cuda_or_raise
from vae_assoc_tpu_torch.train.step import TrainState, init_train_state, make_train_step
from vae_assoc_tpu_torch.utils import checkpoint as ckpt


class AssocVariationalAutoEncoder:
    """K-modality associative VAE with the reference's verb set.

    ``AssocVariationalAutoEncoder([arch_img, arch_traj], assoc_lambda=...,
    learning_rate=..., batch_size=..., device="cuda")``. Without a GPU
    ``device="cuda"`` raises; pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        network_architectures: Sequence[Mapping[str, int]],
        *,
        recon_types: Optional[Sequence[str]] = None,
        names: Optional[Sequence[str]] = None,
        transfer_fct: str = "softplus",
        assoc_lambda: float = 1.0,
        assoc_form: str = "mean_l2",
        assoc_temp: float = 0.1,
        learning_rate: float = 1e-3,
        batch_size: int = 64,
        seed: int = 0,
        n_cond: int = 0,
        train_config: Optional[TrainConfig] = None,
        model_config: Optional[AssocConfig] = None,
        device="cuda",
    ):
        self.device = cuda_or_raise(device, type(self).__name__)
        if model_config is not None:
            self.config = model_config
        else:
            k = len(network_architectures)
            if recon_types is None:
                recon_types = ["bernoulli"] * k
            if names is None:
                names = [f"modality_{i}" for i in range(k)]
            self.config = AssocConfig(
                [
                    ModalityConfig(nm, arch, recon=rt, transfer=transfer_fct, n_cond=n_cond)
                    for nm, arch, rt in zip(names, network_architectures, recon_types)
                ],
                assoc_lambda=assoc_lambda,
                assoc_form=assoc_form,
                assoc_temp=assoc_temp,
            )
        self.train_config = train_config or TrainConfig(
            learning_rate=learning_rate, batch_size=batch_size, seed=seed
        )
        self.state: TrainState = init_train_state(self.config, self.train_config,
                                                  device=self.device)
        # partial_fit is a one-minibatch verb: always the single-step
        # variant; train(...) and train_loop honour steps_per_call.
        self._step_fn = make_train_step(
            self.config, dataclasses.replace(self.train_config, steps_per_call=1)
        )
        # The prior-sample stream advances per call, as the reference's
        # stateful random_normal did.
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.train_config.seed + 1)
        self._kw = dict(cfg=self.config, compute_dtype=self.train_config.compute_dtype,
                        use_pallas=self.train_config.use_pallas)

    def _host_cond(self, cond, batch: int):
        """The condition validated on the host before any device work:
        integer labels are range-checked and one-hot encoded
        (bucketing.check_cond, the serving surfaces' gate), so an
        out-of-range label raises instead of encoding a blank condition."""
        if isinstance(cond, torch.Tensor):
            cond = cond.detach().cpu().numpy()
        c = bucketing.check_cond(None if cond is None else np.asarray(cond),
                                 self.config.n_cond, batch)
        return None if c is None else torch.from_numpy(c).to(self.device)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.detach().to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _host_xs(self, xs: Sequence) -> list:
        """The batch list on the device, a trailing cond entry validated."""
        k = len(self.config.modalities)
        xs = list(xs)
        out = [self._tensor(x) for x in xs[:k]]
        for i, x in enumerate(out):
            # An empty slice would train on mean-of-nothing NaNs and
            # silently poison the weights.
            if x.ndim < 1 or x.shape[0] == 0:
                raise ValueError(
                    f"batch for modality {i} ({self.config.modalities[i].name})"
                    f" is empty: shape {tuple(x.shape)}"
                )
        rest = xs[k:]
        if self.config.n_cond and len(rest) == 1:
            rest = [self._host_cond(rest[0], int(out[0].shape[0]))]
        return out + [self._tensor(x) for x in rest]

    # -- training ----------------------------------------------------------
    def partial_fit(self, xs: Sequence) -> float:
        """One optimizer step on a list of per-modality minibatches.

        Conditional models (``n_cond > 0``): append the condition as one
        extra trailing entry, ``[X_0, ..., X_{K-1}, cond]``, with int labels
        [B] or one-hot [B, n_cond]. Returns the joint cost; the host sync
        this takes exists for API parity (``train_loop`` avoids it)."""
        xs = self._host_xs(xs)
        self.state, metrics = self._step_fn(self.state, xs)
        return float(metrics["total"])

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def transform(self, xs: Sequence):
        """Per-modality latent means [μ_0..μ_{K-1}]. Conditional models:
        append the condition as the trailing entry."""
        return assoc_mod.transform(self.state.params, self._host_xs(xs), **self._kw)

    @torch.no_grad()
    def generate(self, z=None, modality: Union[int, str] = 0, *, cond=None):
        """Decode z (or a fresh standard-normal draw from the model's prior
        stream) with one modality's decoder. Conditional models require
        ``cond`` (labels [B] or one-hot [B, n_cond])."""
        if z is None:
            b = 1 if cond is None else len(cond)
            z = torch.randn((b, self.config.n_z), generator=self._gen, device=self.device)
        z = self._tensor(z)
        c = None if cond is None else self._host_cond(cond, int(z.shape[0]))
        return assoc_mod.generate(self.state.params, z, modality=modality, cond=c, **self._kw)

    @torch.no_grad()
    def reconstruct(self, xs: Sequence, *, sample: bool = False):
        """Per-modality reconstructions.

        ``sample=False``: the deterministic mean path (encode → μ →
        decode). ``sample=True``: through z = μ + σ·ε with ε drawn from the
        model's prior stream, the reference's semantics. Conditional
        models: trailing cond entry."""
        xs_norm = self._host_xs(xs)
        xs_split, cond = assoc_mod.split_cond(xs_norm, self.config)
        params = self.state.params
        if not sample:
            zs = assoc_mod.transform(params, xs_norm, **self._kw)
            return tuple(assoc_mod.generate(params, z, modality=i, cond=cond, **self._kw)
                         for i, z in enumerate(zs))
        return tuple(
            vae_mod.reconstruct(
                p, x, m, compute_dtype=self.train_config.compute_dtype, cond=cond,
                eps=torch.randn((x.shape[0], m.arch["n_z"]), generator=self._gen,
                                device=self.device),
            )
            for p, x, m in zip(params.modalities, xs_split, self.config.modalities)
        )

    @torch.no_grad()
    def cross_generate(self, x, src: Union[int, str], dst: Union[int, str], *, cond=None):
        """Encode with modality ``src``, decode with modality ``dst``.
        Conditional models: pass ``cond`` (labels [B] or one-hot)."""
        x = self._tensor(x)
        c = None if cond is None else self._host_cond(cond, int(x.shape[0]))
        return assoc_mod.cross_generate(self.state.params, x, src=src, dst=dst, cond=c,
                                        **self._kw)

    # -- persistence ---------------------------------------------------------
    def save_model(self, path: str, step: Optional[int] = None) -> str:
        """Checkpoint the whole state and write ``model_config.json`` beside
        it, so :meth:`load` needs no constructor arguments."""
        out = ckpt.save(path, self.state, step=step)
        with open(os.path.join(out, "model_config.json"), "w") as f:
            json.dump(config_to_dict(self.config, self.train_config), f, indent=1)
        return out

    def restore_model(self, path: str, step: Optional[int] = None) -> None:
        self.state = ckpt.restore(path, self.state, step=step)

    @classmethod
    def load(cls, path: str, step: Optional[int] = None, *, device="cuda"):
        """A model rebuilt from a :meth:`save_model` directory alone."""
        cfg_path = os.path.join(os.path.abspath(os.path.expanduser(str(path))),
                                "model_config.json")
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(
                f"no model_config.json under {path}; was this saved with save_model()?"
            )
        with open(cfg_path) as f:
            cfg, tc = config_from_dict(json.load(f))
        model = cls([], model_config=cfg, train_config=tc, device=device)
        model.restore_model(path, step=step)
        return model


def train(
    model_or_archs,
    data: Sequence,
    *,
    training_epochs: int = 10,
    display_step: int = 5,
    fused: bool = False,
    on_epoch=None,
    **model_kwargs,
):
    """Module-level training helper mirroring the reference's ``train(...)``.

    ``model_or_archs``: an :class:`AssocVariationalAutoEncoder`, or a list
    of architecture dicts to build one (``**model_kwargs`` go to the
    constructor). ``data``: K row-paired arrays [N, n_input_k].
    ``fused=True`` runs ``train_loop_fused``, which syncs with the host once
    at the end, and then replays the history to ``on_epoch(epoch,
    metrics)`` every ``display_step`` epochs; ``fused=False`` runs
    ``train_loop``, which calls it as each such epoch ends.

    Returns (model, history)."""
    from vae_assoc_tpu_torch.train.loop import train_loop, train_loop_fused

    if isinstance(model_or_archs, AssocVariationalAutoEncoder):
        model = model_or_archs
    else:
        model = AssocVariationalAutoEncoder(model_or_archs, **model_kwargs)
    if fused:
        state, history = train_loop_fused(
            model.config, model.train_config, data,
            epochs=training_epochs, state=model.state,
        )
        if on_epoch is not None:
            for e, h in enumerate(history):
                if e % display_step == 0:
                    on_epoch(e, h)
    else:
        state, history = train_loop(
            model.config, model.train_config, data,
            epochs=training_epochs, state=model.state,
            display_step=display_step, on_metrics=on_epoch,
        )
    model.state = state
    return model, history


class VariationalAutoencoder(AssocVariationalAutoEncoder):
    """Single-modality VAE, the reference's ``vae.py`` class surface:
    ``partial_fit(X)`` / ``transform(X)`` / ``generate(z)`` /
    ``reconstruct(X)`` take single arrays instead of per-modality lists."""

    def __init__(
        self,
        network_architecture: Optional[Mapping[str, int]] = None,
        *,
        recon_type: str = "bernoulli",
        transfer_fct: str = "softplus",
        learning_rate: float = 1e-3,
        batch_size: int = 64,
        seed: int = 0,
        n_cond: int = 0,
        train_config: Optional[TrainConfig] = None,
        model_config: Optional[AssocConfig] = None,
        device="cuda",
    ):
        if model_config is not None:
            # load() rebuilds through cls([], model_config=..., ...).
            if len(model_config.modalities) != 1:
                raise ValueError(
                    "VariationalAutoencoder is single-modality; the saved "
                    f"config has {len(model_config.modalities)} modalities "
                    "— use AssocVariationalAutoEncoder.load()"
                )
            super().__init__([], model_config=model_config, train_config=train_config,
                             device=device)
            return
        if network_architecture is None:
            raise ValueError("network_architecture is required")
        super().__init__(
            [network_architecture],
            recon_types=[recon_type],
            names=["x"],
            transfer_fct=transfer_fct,
            assoc_lambda=0.0,
            learning_rate=learning_rate,
            batch_size=batch_size,
            seed=seed,
            n_cond=n_cond,
            train_config=train_config,
            device=device,
        )

    def partial_fit(self, X, cond=None) -> float:
        return super().partial_fit([X] if cond is None else [X, cond])

    def transform(self, X, cond=None):
        return super().transform([X] if cond is None else [X, cond])[0]

    def reconstruct(self, X, *, sample: bool = False, cond=None):
        return super().reconstruct([X] if cond is None else [X, cond], sample=sample)[0]
