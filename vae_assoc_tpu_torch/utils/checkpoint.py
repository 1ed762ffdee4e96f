"""Save and load a served model: ``model_config.json`` plus ``params.pt``.

``model_config.json`` uses the schema both packages share
(configs.config_to_dict); ``params.pt`` is the model's state_dict, whose keys
mirror the JAX param tree. Directories written by the JAX package hold an
orbax checkpoint instead; converting those is a later port item, so loading
one raises FileNotFoundError rather than guessing.
"""

from __future__ import annotations

import json
import os

import torch

from vae_assoc_tpu_torch.configs import (
    AssocConfig, TrainConfig, config_to_dict, load_model_config,
)
from vae_assoc_tpu_torch.models.assoc import AssocVAE
from vae_assoc_tpu_torch.models.networks import cuda_or_raise

PARAMS_FILE = "params.pt"


def save_params(path: str, model: AssocVAE, cfg: AssocConfig,
                tc: TrainConfig | None = None) -> str:
    """Write ``model_config.json`` and ``params.pt`` under ``path``."""
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(config_to_dict(cfg, tc), f, indent=2)
    torch.save(model.state_dict(), os.path.join(path, PARAMS_FILE))
    return path


def load_params(path: str, *, device="cuda"):
    """Read a directory written by :func:`save_params` → (model, cfg, tc),
    the weights on ``device``: the card unless the caller names the CPU
    (without a GPU ``device="cuda"`` raises)."""
    device = cuda_or_raise(device, "load_params")
    cfg, tc, _ = load_model_config(path)
    path = os.path.abspath(os.path.expanduser(path))
    params_path = os.path.join(path, PARAMS_FILE)
    if not os.path.exists(params_path):
        raise FileNotFoundError(
            f"no {PARAMS_FILE} under {path}. A model directory written by the "
            "JAX package holds an orbax checkpoint; converting orbax "
            "checkpoints to the port is a later port item. Until then, carry "
            "the weights with vae_assoc_tpu_torch.convert.from_jax_numpy and "
            "save_params()."
        )
    model = AssocVAE(cfg, device=device)
    state = torch.load(params_path, map_location=device, weights_only=True)
    model.load_state_dict(state, strict=True)
    return model, cfg, tc
