"""Carry weights between the JAX package's param tree and the port's modules.

The JAX tree is ``{"modalities": (p_0, ..., p_{K-1})}`` with each
``p_k = {"recog": {"h1": {"w", "b"}, ...}, "gener": {...}}`` and ``w`` laid
out [in, out] (vae_assoc_tpu/models/assoc.py). The port keeps that layout
and names, so a tree path maps to a state_dict key by joining with dots
(``modalities.0.recog.h1.w``) and no array is transposed. The input is the
tree as numpy, ``jax.tree.map(np.asarray, params)``: nothing here imports
JAX.

A training run carries over too: ``train_state_from_jax_numpy`` takes the
Adam state of an optax chain (``ScaleByAdamState``: ``count``, ``mu``,
``nu``, the moments as numpy trees of the params' layout) and the
``TrainState.step``, and ``train_state_to_jax_numpy`` gives them back. The
other stages' state (MultiSteps accumulators, EMA) is not carried.
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


def _tree(named) -> dict:
    """Dotted keys and tensors → the JAX-layout tree of numpy arrays."""
    mods: dict = {}
    for key, t in named:
        _, i, *path = key.split(".")
        node = mods.setdefault(int(i), {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t.detach().cpu().numpy().copy()
    return {"modalities": tuple(mods[i] for i in sorted(mods))}


def to_numpy(model: AssocVAE) -> dict:
    """Inverse of :func:`from_jax_numpy`: the JAX-layout tree as numpy."""
    return _tree(model.state_dict().items())


def train_state_from_jax_numpy(params, adam, step, cfg: AssocConfig, tc, device):
    """The port's TrainState continuing a JAX run: ``params`` the numpy param
    tree, ``adam`` = (count, mu tree, nu tree) of optax's ScaleByAdamState as
    numpy, ``step`` the JAX TrainState.step. The ε stream restarts from
    ``tc.seed`` (the two packages' streams differ by design)."""
    from vae_assoc_tpu_torch.train.step import init_train_state

    model = from_jax_numpy(params, cfg, device)
    state = init_train_state(cfg, tc, device=device, params=model)
    count, mu, nu = adam
    moments = (dict(_flatten(mu)), dict(_flatten(nu)))
    with torch.no_grad():
        for i, (key, _) in enumerate(model.named_parameters()):
            for dst, src in zip((state.opt_state.adam.mu, state.opt_state.adam.nu), moments):
                dst[i].copy_(torch.from_numpy(np.array(src[key], dtype=np.float32)))
    state.opt_state.adam.count = int(count)
    return state._replace(step=int(step))


def train_state_to_jax_numpy(state):
    """Inverse of :func:`train_state_from_jax_numpy`:
    (params tree, (count, mu tree, nu tree), step), all numpy."""
    names = [k for k, _ in state.params.named_parameters()]
    adam = state.opt_state.adam
    return (to_numpy(state.params),
            (np.int32(adam.count), _tree(zip(names, adam.mu)), _tree(zip(names, adam.nu))),
            np.int32(state.step))
