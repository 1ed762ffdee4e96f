"""Carry weights between the JAX package's param tree and the port's modules.

The JAX tree is ``{"modalities": (p_0, ..., p_{K-1})}`` with each
``p_k = {"recog": {"h1": {"w", "b"}, ...}, "gener": {...}}`` and ``w`` laid
out [in, out] (vae_assoc_tpu/models/assoc.py). The port keeps that layout
and names, so a tree path maps to a state_dict key by joining with dots
(``modalities.0.recog.h1.w``) and no array is transposed. The input is the
tree as numpy, ``jax.tree.map(np.asarray, params)``: nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from vae_assoc_tpu_torch.configs import AssocConfig
from vae_assoc_tpu_torch.models.assoc import AssocVAE


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}.{k}" if prefix else str(k))


def from_jax_numpy(tree, cfg: AssocConfig, device) -> AssocVAE:
    """The port's model holding the weights of a numpy JAX param tree.

    Raises if a key is missing or extra, or a shape differs."""
    model = AssocVAE(cfg, device=device)
    state = {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in _flatten(tree)
    }
    model.load_state_dict(state, strict=True)
    return model


def to_numpy(model: AssocVAE) -> dict:
    """Inverse of :func:`from_jax_numpy`: the JAX-layout tree as numpy."""
    mods: dict = {}
    for key, t in model.state_dict().items():
        _, i, *path = key.split(".")
        node = mods.setdefault(int(i), {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t.detach().cpu().numpy().copy()
    return {"modalities": tuple(mods[i] for i in sorted(mods))}
