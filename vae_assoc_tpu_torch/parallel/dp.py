"""Data-parallel training over a mesh (counterpart of vae_assoc_tpu/parallel/dp.py).

Every rank holds the whole state and its rows of each global batch, runs
the unchanged train step on them, the kernels included (every
``use_pallas`` setting), and joins one all-reduce of its gradients,
bucketed into one flat tensor and divided by the number of ranks
(``train.step._one_step(group=)``). The step therefore follows the
gradient of the global batch's mean loss, as the JAX package's shard_map
step does with its loss ``pmean``. Each rank folds its rank into the ε
seed (the JAX package folds ``axis_index``), and InfoNCE with global
negatives gathers them over the data group.

Config 5 is this layout (8-way in the JAX package's mesh). On one card it
runs at world size 1, where the all-reduce changes nothing.
"""

from __future__ import annotations

from typing import Sequence

import torch.distributed as dist

from vae_assoc_tpu_torch.configs import AssocConfig, TrainConfig
from vae_assoc_tpu_torch.parallel import mesh as mesh_mod
from vae_assoc_tpu_torch.train import loop as loop_mod
from vae_assoc_tpu_torch.train import step as step_mod
from vae_assoc_tpu_torch.train.step import (
    TrainState,
    _one_step,
    init_train_state,
    make_optimizer,
)


def batch_group(mesh, batch_axes=None):
    """The process group of the mesh axes a batch shards over: one axis's
    group, or the whole group where the axes are all of the mesh's."""
    axes = mesh_mod.batch_spec(mesh, batch_axes=batch_axes).axes
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if set(axes) == set(mesh.mesh_dim_names) and mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    raise ValueError(f"batch axes {axes} span part of the mesh {mesh.mesh_dim_names}; "
                     "shard over one axis or over all of them")


def make_dp_train_step(cfg: AssocConfig, tc: TrainConfig, mesh, *, batch_axes=None):
    """The data-parallel step over ``mesh``: ``step_fn(state, xs, eps=None)
    -> (state', metrics)`` as ``train.step.make_train_step``'s, where each
    tensor of ``xs`` is this rank's rows of a global batch (``shard_batch``)
    and the state is replicated (``init_dp_train_state``); ``eps``, one
    tensor per modality, injects this rank's rows of ε.

    ``batch_axes``: the mesh axes the batch shards over, the first by
    default; ``("replica", "data")`` of ``make_multihost_mesh`` averages
    the gradients over both levels in one all-reduce."""
    group = batch_group(mesh, batch_axes)
    opt = make_optimizer(tc)

    def one(state, xs, eps):
        return _one_step(state, xs, cfg, tc, opt, eps=eps, group=group)

    return step_mod.stacked_steps(one, tc.steps_per_call)


def init_dp_train_state(cfg: AssocConfig, tc: TrainConfig, mesh, *, params=None) -> TrainState:
    """A TrainState on this rank's device of ``mesh`` (the card unless the
    mesh is of CPUs), replicated from the mesh's first rank."""
    state = init_train_state(cfg, tc, device=mesh_mod.mesh_device(mesh, "init_dp_train_state"),
                             params=params)
    mesh_mod.replicate(mesh, state)
    return state


def dp_train_loop(cfg: AssocConfig, tc: TrainConfig, data: Sequence, mesh, *,
                  epochs: int = 10, state: TrainState | None = None,
                  display_step: int = 1, on_metrics=None, shuffle: bool = True,
                  refresh_data=None):
    """The epoch loop of the DP step, the scaled-out ``train.loop.train_loop``.

    ``data``: K row-paired arrays [N, n_input_k], the same on every rank.
    Each epoch is shuffled by the JAX package's stream, cut into global
    batches of ``tc.batch_size`` (divisible by the mesh size) and consumed
    in ``steps_per_call`` stacks; a rank gathers only its rows on its
    device. ``refresh_data`` as ``train_loop``'s. Returns (state, history)."""
    if state is None:
        state = init_dp_train_state(cfg, tc, mesh)
    index, count = mesh_mod.shard_index(mesh, mesh_mod.batch_spec(mesh).axes)
    return _epoch_loop(tc, data, mesh, make_dp_train_step(cfg, tc, mesh), state,
                       shard=(index, count), epochs=epochs, display_step=display_step,
                       on_metrics=on_metrics, shuffle=shuffle, refresh_data=refresh_data)


def _epoch_loop(tc: TrainConfig, data: Sequence, mesh, step_fn, state: TrainState, *,
                shard: tuple, **kw):
    """The epoch loop of the sharded steps (DP, ZeRO, TP and DP×TP):
    ``train.loop.epoch_loop`` on this rank's device, where ``shard`` =
    (index, count) takes rows [index·B/count, (index+1)·B/count) of every
    global batch (count 1 where the batch is replicated, as in pure TP).
    ``samples_per_sec`` counts the global batch, ``_per_chip`` divides it
    by the mesh's devices."""
    dev_data = loop_mod._stage(data, mesh_mod.mesh_device(mesh))
    return loop_mod.epoch_loop(tc, dev_data, step_fn, state,
                               rows=mesh_mod.shard_rows(tc.batch_size, *shard),
                               n_chips=mesh.size(), **kw)
