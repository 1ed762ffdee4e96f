"""Typed configuration for the PyTorch port (counterpart of vae_assoc_tpu/configs.py).

The reference configures models through architecture dicts with keys
``n_input, n_z, n_hidden_recog_1, n_hidden_recog_2, n_hidden_gener_1,
n_hidden_gener_2``; dataclasses wrap them with the training and precision
options. The JSON schema of :func:`config_to_dict` / :func:`config_from_dict`
is the JAX package's, field for field, so each package reads the other's
``model_config.json``. Dtypes are stored as names (``"float32"``,
``"bfloat16"``); ``TrainConfig.use_pallas`` keeps its name for the same
reason and selects the hand-written CUDA kernels here.

The five build configs are exposed as :func:`baseline_config` milestones 1-5.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from vae_assoc_tpu_torch.models.networks import dtype_name, softplus

# The association forms of the joint objective (ops/losses.py::assoc_loss;
# vae_assoc_tpu/ops/losses.py ASSOC_FORMS).
ASSOC_FORMS = ("mean_l2", "sample_l2", "sym_kl", "infonce")


class FrozenDict(Mapping):
    """Immutable, hashable mapping, so whole configs can be dict keys."""

    __slots__ = ("_d", "_h")

    def __init__(self, d: Mapping):
        object.__setattr__(self, "_d", dict(d))
        object.__setattr__(self, "_h", None)

    def __getitem__(self, k):
        return self._d[k]

    def __iter__(self) -> Iterator:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __hash__(self) -> int:
        if self._h is None:
            object.__setattr__(self, "_h", hash(tuple(sorted(self._d.items()))))
        return self._h

    def __eq__(self, other) -> bool:
        if isinstance(other, (FrozenDict, dict, Mapping)):
            return dict(self._d) == dict(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"FrozenDict({self._d!r})"


# Architecture-dict keys of the reference constructor. Deeper stacks use
# contiguous n_hidden_recog_3, n_hidden_gener_3, ... keys (validate_arch).
ARCH_KEYS = (
    "n_input",
    "n_z",
    "n_hidden_recog_1",
    "n_hidden_recog_2",
    "n_hidden_gener_1",
    "n_hidden_gener_2",
)

_HIDDEN_KEY_RE = re.compile(r"^n_hidden_(recog|gener)_([1-9]\d*)$")


def validate_arch(arch: Mapping[str, int]) -> FrozenDict:
    """Validate an architecture dict; returns an immutable hashable copy.

    Accepts the reference's key set plus deeper stacks: any number of
    ``n_hidden_recog_k`` / ``n_hidden_gener_k`` keys, each family contiguous
    from 1. Unrecognized keys, gaps and non-positive widths raise. The two
    nets' depths may differ; each needs at least one hidden layer.
    """
    hidden = {"recog": {}, "gener": {}}
    out = {}
    for k in arch:
        if k in ("n_input", "n_z"):
            out[k] = int(arch[k])
            continue
        m = _HIDDEN_KEY_RE.match(k)
        if not m:
            raise ValueError(
                f"unrecognized architecture key {k!r}; expected n_input, "
                "n_z, and contiguous n_hidden_recog_k / n_hidden_gener_k"
            )
        hidden[m.group(1)][int(m.group(2))] = int(arch[k])
    missing = [k for k in ("n_input", "n_z") if k not in out]
    if missing:
        raise ValueError(f"architecture dict missing keys: {missing}")
    for net, layers in hidden.items():
        if not layers:
            raise ValueError(f"architecture dict has no n_hidden_{net}_* keys")
        depth = max(layers)
        want = list(range(1, depth + 1))
        if sorted(layers) != want:
            raise ValueError(
                f"n_hidden_{net}_* keys must be contiguous from 1; got "
                f"layers {sorted(layers)}"
            )
        for k in want:
            out[f"n_hidden_{net}_{k}"] = layers[k]
    for k, v in out.items():
        if v <= 0:
            raise ValueError(f"architecture dim {k}={v} must be positive")
    return FrozenDict(out)


def _hidden_widths(arch: Mapping[str, int], net: str) -> tuple:
    widths = []
    k = 1
    while f"n_hidden_{net}_{k}" in arch:
        widths.append(int(arch[f"n_hidden_{net}_{k}"]))
        k += 1
    return tuple(widths)


def recog_widths(arch: Mapping[str, int]) -> tuple:
    """Hidden-layer widths of the recognition net, in forward order."""
    return _hidden_widths(arch, "recog")


def gener_widths(arch: Mapping[str, int]) -> tuple:
    """Hidden-layer widths of the generator net, in forward order."""
    return _hidden_widths(arch, "gener")


# The reference's `transfer_fct` knob, by name. jax.nn.gelu defaults to the
# tanh approximation, so the port's gelu is F.gelu(approximate="tanh").
# The fused CUDA MLP kernels implement softplus; other transfers run the
# plain torch path (models/vae._net_fns).
TRANSFER_FNS = {
    "softplus": softplus,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
}


def _hidden_keys(hidden: int, depth: int) -> dict:
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    out = {}
    for k in range(1, depth + 1):
        out[f"n_hidden_recog_{k}"] = hidden
        out[f"n_hidden_gener_{k}"] = hidden
    return out


def default_image_arch(n_z: int = 20, hidden: int = 500, depth: int = 2) -> dict:
    """28x28 grayscale character image branch; ``depth`` hidden layers per net."""
    return dict(n_input=784, n_z=n_z, **_hidden_keys(hidden, depth))


def default_traj_arch(
    n_dims: int = 2,
    n_timesteps: int = 100,
    n_z: int = 20,
    hidden: int = 500,
    depth: int = 2,
) -> dict:
    """Fixed-length flattened pen-stroke trajectory branch (x0, y0, x1, y1, ...)."""
    return dict(
        n_input=n_dims * n_timesteps, n_z=n_z, **_hidden_keys(hidden, depth)
    )


@dataclasses.dataclass(frozen=True)
class ModalityConfig:
    """One modality of the joint model.

    Attributes:
      name: modality identifier (e.g. "image", "trajectory").
      arch: reference-style architecture dict (see :data:`ARCH_KEYS`).
      recon: "bernoulli" (sigmoid output) or "gaussian" (linear output).
      encoder: "mlp", or a conv image tower (models/conv.py): "conv" on
        plain torch convs, "conv_pallas" on the hand-written conv kernels
        (kernels/conv.py; kernels/conv_mega.py under use_pallas="mega")
        whatever ``use_pallas`` says, as in the reference.
      transfer: hidden activation, a key of :data:`TRANSFER_FNS`.
      n_cond: conditional-VAE one-hot width (0 = unconditional). The
        condition is concatenated to the encoder input and to z at the
        call boundary (models/vae.py).
    """

    name: str
    arch: Mapping[str, int]
    recon: str = "bernoulli"
    encoder: str = "mlp"
    transfer: str = "softplus"
    n_cond: int = 0

    def __post_init__(self):
        object.__setattr__(self, "arch", validate_arch(self.arch))
        if self.recon not in ("bernoulli", "gaussian"):
            raise ValueError(f"unknown recon likelihood: {self.recon!r}")
        if self.encoder not in ("mlp", "conv", "conv_pallas"):
            raise ValueError(f"unknown encoder type: {self.encoder!r}")
        if self.encoder.startswith("conv") and self.arch["n_input"] != 784:
            raise ValueError("conv encoder requires 28x28 (n_input=784) input")
        if self.encoder.startswith("conv") and (
            len(recog_widths(self.arch)) != 2 or len(gener_widths(self.arch)) != 2
        ):
            raise ValueError(
                "conv encoders use the fixed 2-hidden-layer arch-dict shape; "
                "deeper stacks are supported by encoder='mlp' only"
            )
        if self.n_cond < 0:
            raise ValueError(f"n_cond must be >= 0, got {self.n_cond}")
        if self.n_cond > 0 and self.encoder != "mlp":
            raise ValueError(
                "conditioning (n_cond > 0) supports MLP towers only; "
                f"got encoder={self.encoder!r}"
            )
        if self.transfer not in TRANSFER_FNS:
            raise ValueError(
                f"unknown transfer_fct {self.transfer!r}; "
                f"options: {sorted(TRANSFER_FNS)}"
            )


@dataclasses.dataclass(frozen=True)
class AssocConfig:
    """Joint associative model: K modalities + association coupling.

    ``assoc_lambda`` weights λ·Σ_{i<j} mean_batch ‖μ_i − μ_j‖² in the
    default ``assoc_form="mean_l2"``; the other forms and
    ``assoc_negatives`` mirror the JAX package and matter to training only.
    All modalities share ``n_z`` and ``n_cond``.
    """

    modalities: Sequence[ModalityConfig]
    assoc_lambda: float = 1.0
    assoc_form: str = "mean_l2"
    assoc_temp: float = 0.1
    assoc_negatives: str = "local"

    def __post_init__(self):
        object.__setattr__(self, "modalities", tuple(self.modalities))
        if self.assoc_form not in ASSOC_FORMS:
            raise ValueError(
                f"unknown assoc_form {self.assoc_form!r}; one of {ASSOC_FORMS}"
            )
        if self.assoc_temp <= 0:
            raise ValueError(f"assoc_temp must be > 0, got {self.assoc_temp}")
        if self.assoc_negatives not in ("local", "global"):
            raise ValueError(
                "assoc_negatives must be 'local' or 'global', got "
                f"{self.assoc_negatives!r}"
            )
        if self.assoc_negatives != "local" and self.assoc_form != "infonce":
            raise ValueError(
                "assoc_negatives='global' only applies to "
                f"assoc_form='infonce' (got {self.assoc_form!r})"
            )
        if len(self.modalities) < 1:
            raise ValueError("need at least one modality")
        if self.assoc_form != "mean_l2" and len(self.modalities) < 2:
            raise ValueError(
                f"assoc_form={self.assoc_form!r} needs >= 2 modalities "
                "(the association term couples modality pairs)"
            )
        n_zs = {m.arch["n_z"] for m in self.modalities}
        if len(n_zs) != 1:
            raise ValueError(f"all modalities must share n_z; got {n_zs}")
        names = [m.name for m in self.modalities]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate modality names: {names}")
        n_conds = {m.n_cond for m in self.modalities}
        if len(n_conds) != 1:
            raise ValueError(f"all modalities must share n_cond; got {n_conds}")

    @property
    def n_z(self) -> int:
        return self.modalities[0].arch["n_z"]

    @property
    def n_cond(self) -> int:
        """Conditional-VAE one-hot width (0 = unconditional)."""
        return self.modalities[0].n_cond

    def modality_index(self, name_or_idx) -> int:
        if isinstance(name_or_idx, (int, np.integer)):
            name_or_idx = int(name_or_idx)
            # Range-checked: a negative index would silently select from
            # the end via Python indexing.
            if not 0 <= name_or_idx < len(self.modalities):
                raise KeyError(
                    f"modality index {name_or_idx} out of range "
                    f"[0, {len(self.modalities)})"
                )
            return name_or_idx
        for i, m in enumerate(self.modalities):
            if m.name == name_or_idx:
                return i
        raise KeyError(f"no modality named {name_or_idx!r}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training and runtime options; the fields of the JAX package's TrainConfig.

    ``compute_dtype`` is "float32", or "bfloat16": bf16 matmul operands with
    fp32 accumulation. ``use_pallas`` selects the hand-written CUDA kernels:
    truthy for serving's forward stacks; in training, True runs the
    composable kernels (fused encoder, sampler, decoder and joint loss, each
    with a backward kernel), "mega" the tower megakernel (a config it does
    not implement falls back to True with a ``MegaFallbackWarning``), and
    False the plain path. The train step (train/step.py) reads every other
    field except ``data_axis``, which is carried so that a
    ``model_config.json`` round-trips unchanged.
    """

    learning_rate: float = 1e-3
    batch_size: int = 64
    compute_dtype: Any = "float32"
    parity_mode: bool = False
    use_pallas: Any = False  # False | True | "mega"
    steps_per_call: int = 1
    data_axis: str = "data"
    seed: int = 0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    lr_end_factor: float = 0.0
    grad_clip_norm: float = 0.0
    accum_steps: int = 1
    ema_decay: float = 0.0
    kl_beta: float = 1.0
    kl_anneal_steps: int = 0
    assoc_warmup_steps: int = 0
    remat: bool = False

    def __post_init__(self):
        object.__setattr__(self, "compute_dtype", dtype_name(self.compute_dtype))


def config_to_dict(cfg: AssocConfig, tc: TrainConfig = None) -> dict:
    """JSON-serializable snapshot of model (+ optional train) config."""
    out = {
        "assoc_lambda": cfg.assoc_lambda,
        "assoc_form": cfg.assoc_form,
        "assoc_temp": cfg.assoc_temp,
        "assoc_negatives": cfg.assoc_negatives,
        "modalities": [
            {
                "name": m.name,
                "arch": dict(m.arch),
                "recon": m.recon,
                "encoder": m.encoder,
                "transfer": m.transfer,
                "n_cond": m.n_cond,
            }
            for m in cfg.modalities
        ],
    }
    if tc is not None:
        out["train"] = dataclasses.asdict(tc)
    return out


def config_from_dict(d: Mapping) -> tuple:
    """Inverse of :func:`config_to_dict` → (AssocConfig, TrainConfig|None)."""
    cfg = AssocConfig(
        [
            ModalityConfig(
                m["name"], m["arch"], recon=m["recon"],
                encoder=m.get("encoder", "mlp"),
                transfer=m.get("transfer", "softplus"),
                n_cond=m.get("n_cond", 0),
            )
            for m in d["modalities"]
        ],
        assoc_lambda=d["assoc_lambda"],
        assoc_form=d.get("assoc_form", "mean_l2"),
        assoc_temp=d.get("assoc_temp", 0.1),
        assoc_negatives=d.get("assoc_negatives", "local"),
    )
    tc = TrainConfig(**d["train"]) if "train" in d else None
    return cfg, tc


def load_model_config(path: str):
    """Read a model directory's ``model_config.json``.

    Returns ``(cfg, tc, raw_dict)``. Raises FileNotFoundError when the file
    is absent.
    """
    path = os.path.abspath(os.path.expanduser(path))
    cfg_path = os.path.join(path, "model_config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"no model_config.json under {path}; write the model with "
            "save_model() (api.py) or utils.checkpoint.save_params()"
        )
    with open(cfg_path) as f:
        raw = json.load(f)
    cfg, tc = config_from_dict(raw)
    return cfg, tc, raw


def baseline_config(milestone: int, **overrides):
    """The five build-config milestones → (AssocConfig, TrainConfig).

      1: single-modality MLP image VAE, batch 64, fp32
      2: trajectory-only VAE
      3: joint associative VAE (image + trajectory)
      4: conv image branch + MLP trajectory branch
      5: data-parallel joint VAE, global batch 1024, bf16 matmuls
    """
    img = ModalityConfig("image", default_image_arch(), recon="bernoulli")
    traj = ModalityConfig("trajectory", default_traj_arch(), recon="gaussian")
    if milestone == 1:
        model = AssocConfig([img], assoc_lambda=0.0)
        train = TrainConfig(batch_size=64, compute_dtype="float32")
    elif milestone == 2:
        model = AssocConfig([traj], assoc_lambda=0.0)
        train = TrainConfig(batch_size=64)
    elif milestone == 3:
        model = AssocConfig([img, traj], assoc_lambda=1.0)
        train = TrainConfig(batch_size=64)
    elif milestone == 4:
        conv_img = dataclasses.replace(img, encoder="conv")
        model = AssocConfig([conv_img, traj], assoc_lambda=1.0)
        train = TrainConfig(batch_size=64, use_pallas="mega")
    elif milestone == 5:
        model = AssocConfig([img, traj], assoc_lambda=1.0)
        train = TrainConfig(
            batch_size=1024,
            compute_dtype="bfloat16",
            use_pallas=True,
            steps_per_call=10,
        )
    else:
        raise ValueError(f"milestone must be 1-5, got {milestone}")
    train = dataclasses.replace(train, **overrides)
    return model, train
