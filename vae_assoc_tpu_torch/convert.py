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
EMA stage's state (``EmaState``: ``count``, ``ema``) and the MultiSteps
accumulator (``mini_step``, ``acc_grads``) carry over where the train
config has them (``ema_decay > 0``, ``accum_steps > 1``).

A sweep state (train/sweep.py) carries over with ``sweep_state_from_jax_numpy``
and back with ``sweep_state_to_jax_numpy``: the same trees with a leading
[E] model axis on every leaf, counts and steps included (the JAX package
vmaps its ``TrainState``), which the port keeps as one count, shared by
the members that advance in lockstep.
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


def _load_tree(dst: list, tree, model: AssocVAE) -> None:
    """Copy a numpy tree of the params' layout into ``dst`` (parameter order)."""
    flat = dict(_flatten(tree))
    with torch.no_grad():
        for i, (key, _) in enumerate(model.named_parameters()):
            dst[i].copy_(torch.from_numpy(np.array(flat[key], dtype=np.float32)))


def train_state_from_jax_numpy(params, adam, step, cfg: AssocConfig, tc, device, *,
                               ema=None, acc=None):
    """The port's TrainState continuing a JAX run: ``params`` the numpy param
    tree, ``adam`` = (count, mu tree, nu tree) of optax's ScaleByAdamState as
    numpy, ``step`` the JAX TrainState.step; ``ema`` = (count, ema tree) of
    the EMA stage and ``acc`` = (mini_step, acc_grads tree) of MultiSteps
    where ``tc`` has those stages. The ε stream restarts from ``tc.seed``
    (the two packages' streams differ by design)."""
    from vae_assoc_tpu_torch.train.step import init_train_state

    model = from_jax_numpy(params, cfg, device)
    state = init_train_state(cfg, tc, device=device, params=model)
    _load_opt(state.opt_state, model, adam, ema, acc, int)
    return state._replace(step=int(step))


def _load_opt(opt, model, adam, ema, acc, count) -> None:
    """Load the optimizer's numpy trees into ``opt`` (in place), each count
    read by ``count``."""
    n, mu, nu = adam
    _load_tree(opt.adam.mu, mu, model)
    _load_tree(opt.adam.nu, nu, model)
    opt.adam.count = count(n)
    for part, dst, what in ((ema, opt.ema, "EMA"), (acc, opt.acc, "MultiSteps")):
        if (part is None) != (dst is None):
            raise ValueError(
                f"the train config has {'no ' if dst is None else 'a '}{what} stage and "
                f"the JAX state {'has none' if part is None else 'has one'}")
    if ema is not None:
        _load_tree(opt.ema, ema[1], model)
        opt.ema_count = count(ema[0])
    if acc is not None:
        _load_tree(opt.acc, acc[1], model)
        opt.mini_step = count(acc[0])


def _lockstep(a) -> int:
    """An [E] count of a JAX sweep state → the one count of the port's."""
    a = np.asarray(a).reshape(-1)
    if (a != a[0]).any():
        raise ValueError(f"the sweep's members are not in lockstep: counts {a.tolist()}")
    return int(a[0])


def sweep_state_from_jax_numpy(params, adam, step, seeds, cfg: AssocConfig, tc, device, *,
                               ema=None, acc=None):
    """The port's sweep state continuing a JAX sweep: the arguments of
    :func:`train_state_from_jax_numpy`, every leaf and count with a leading
    [E] axis, and the members' ``seeds`` (their ε streams restart from them)."""
    from vae_assoc_tpu_torch.train.sweep import init_sweep_state

    state = init_sweep_state(cfg, tc, seeds, device=device)
    _load_tree(list(state.params.parameters()), params, state.params)
    _load_opt(state.opt_state, state.params, adam, ema, acc, _lockstep)
    return state._replace(step=_lockstep(step))


def sweep_state_to_jax_numpy(state):
    """Inverse of :func:`sweep_state_from_jax_numpy`: (params tree, (count,
    mu tree, nu tree), step), every leaf and count with the leading [E] axis."""
    params, (count, mu, nu), step = train_state_to_jax_numpy(state)
    e = len(state.seed)
    return params, (np.full(e, count, np.int32), mu, nu), np.full(e, step, np.int32)


def train_state_to_jax_numpy(state):
    """Inverse of :func:`train_state_from_jax_numpy`:
    (params tree, (count, mu tree, nu tree), step), all numpy."""
    names = [k for k, _ in state.params.named_parameters()]
    adam = state.opt_state.adam
    return (to_numpy(state.params),
            (np.int32(adam.count), _tree(zip(names, adam.mu)), _tree(zip(names, adam.nu))),
            np.int32(state.step))
