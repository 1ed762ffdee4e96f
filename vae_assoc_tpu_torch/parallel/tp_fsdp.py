"""TP × FSDP: tensor parallelism with the state sharded over the data group
(counterpart of vae_assoc_tpu/parallel/tp_fsdp.py).

A composition of the two layouts the port has, not a third:

- **Storage.** Each rank's tensor-parallel shard (``parallel/tp.py``: its
  model rank's column, row and channel slices, padded over the model group)
  is cut into ZeRO's flat padded slices over the data group
  (``parallel/slices.py``): rank (d, m) stores slice d of model shard m of
  every parameter and optimizer list. A rank's state is about the total
  ÷ (D·M), plus the pads.
- **The step.** One all-gather over ``data`` rebuilds the rank's TP shard
  (the transient weights, a model the step keeps); the TP step's objective
  and gradient run on it (``tp.tp_grads``: pair blocks on the stack kernels
  for MLP towers, channel splits for conv towers, Megatron's f and g over
  the model group, the pads masked); one reduce-scatter over ``data``
  leaves each rank the mean of its slices, in place of DP × TP's gradient
  all-reduce; Adam updates the slices. Clipping compares the norm of the
  whole gradient: the split leaves' squares summed over the data and the
  model group, the replicated leaves' over the data group alone.

The semantics are DP × TP's: a rank takes its data rank's rows of each
global batch, ε folds the data rank, and the gradient is that of the
global batch's mean loss; at the same global batch the trajectory follows
``tp.make_gspmd_tp_train_step`` on the same mesh.

It covers what the GSPMD TP names cover (``tp.check_tp``), on a 2-D
``("data", "model")`` mesh. Two deliberate differences from the JAX
package's layout: the MLP towers keep the kernels (JAX rejects
``use_pallas``), and every leaf is cut into flat slices, where JAX keeps a
leaf whose dim the data axis does not divide on its TP placement alone.

A rank holds only its slices, so ``gather_tp_fsdp_train_state`` is a
collective over the mesh (the JAX arrays are global, so there it is a
reshape), and ``shard_tp_fsdp_train_state`` cuts a whole state that every
rank holds. A checkpoint is the whole state of the gather.
"""

from __future__ import annotations

import math

import torch

from vae_assoc_tpu_torch.configs import AssocConfig, TrainConfig
from vae_assoc_tpu_torch.models.assoc import AssocVAE
from vae_assoc_tpu_torch.parallel import mesh as mesh_mod
from vae_assoc_tpu_torch.parallel import slices, tp
from vae_assoc_tpu_torch.train import step as step_mod
from vae_assoc_tpu_torch.train.step import TrainState, init_train_state, make_optimizer

DATA, MODEL = mesh_mod.DATA_AXIS, mesh_mod.MODEL_AXIS


def _check_tp_fsdp(mesh, tc: TrainConfig, cfg: AssocConfig) -> tuple:
    """(data ranks D, model ranks M) of a mesh of this layout; rejects any
    other mesh and what the GSPMD TP names reject."""
    names = tuple(mesh.mesh_dim_names or ())
    if names != (DATA, MODEL):
        raise ValueError(
            f"TP×FSDP needs a 2-D ('{DATA}', '{MODEL}') mesh — build one with "
            "tp.make_tp_mesh(n, data_parallel=D) or make_mesh(n, model_axis='model', "
            f"model_parallel=K); got axes {names}"
        )
    tp.check_tp(cfg, tc)
    return mesh.size(0), mesh.size(1)


def tp_fsdp_param_specs(cfg: AssocConfig, data_shards: int, *, model_shards: int) -> dict:
    """How each parameter lies in the layout: state_dict key → (the dim it
    is split along over the model group or None, the shape of a model
    shard, the length of a rank's flat slice of it over the data group)."""
    dims = tp.tp_param_specs(cfg)
    out = {}
    for key, p in AssocVAE(cfg, device="meta").named_parameters():
        d, shape = dims[key], list(p.shape)
        if d is not None:
            shape[d] = slices.pad_len(shape[d], model_shards) // model_shards
        out[key] = (d, tuple(shape),
                    slices.pad_len(math.prod(shape), data_shards) // data_shards)
    return out


def shard_tp_fsdp_train_state(mesh, state: TrainState, cfg: AssocConfig,
                              tc: TrainConfig) -> TrainState:
    """A whole TrainState, the same on every rank, → this rank's flat slice
    of its TP shard of every parameter and optimizer list, on the state's
    device; the step, the seed and the optimizer's counts as they are."""
    n_data, n_model = _check_tp_fsdp(mesh, tc, cfg)
    d, m = mesh.get_local_rank(DATA), mesh.get_local_rank(MODEL)
    dims = list(tp.tp_param_specs(cfg).values())

    def cut(ts):
        return [slices.cut(tp.cut_shard(t, dim, n_model, m), n_data, d)
                for t, dim in zip(ts, dims)]

    return TrainState(state.step, cut(state.params.parameters()),
                      state.opt_state.map_lists(cut), state.seed)


@torch.no_grad()
def gather_tp_fsdp_train_state(fstate: TrainState, cfg: AssocConfig, tc: TrainConfig,
                               mesh) -> TrainState:
    """Inverse of :func:`shard_tp_fsdp_train_state`, on every rank: one
    all-gather over ``data`` rebuilds the TP shards, and
    ``tp.gather_tp_train_state`` the whole state. A collective over the
    mesh (every rank calls it)."""
    n_data, n_model = _check_tp_fsdp(mesh, tc, cfg)
    shapes = [s for _, s, _ in tp_fsdp_param_specs(cfg, n_data, model_shards=n_model).values()]
    lists = [fstate.params] + [l for l in fstate.opt_state.lists() if l is not None]
    full = slices.gather_full([t for l in lists for t in l], shapes * len(lists), n_data,
                              mesh.get_group(DATA))
    per = [full[i * len(shapes):(i + 1) * len(shapes)] for i in range(len(lists))]
    model = tp.shard_params(mesh, AssocVAE(cfg, device=fstate.params[0].device), cfg)
    torch._foreach_copy_(list(model.parameters()), per[0])
    it = iter(per[1:])
    opt = fstate.opt_state.map_lists(lambda _: [t.clone() for t in next(it)])
    return tp.gather_tp_train_state(TrainState(fstate.step, model, opt, fstate.seed), cfg, tc,
                                    mesh)


def init_tp_fsdp_train_state(cfg: AssocConfig, tc: TrainConfig, mesh, *,
                             params=None) -> TrainState:
    """Step 0 (from ``tc.seed``, or ``params``) in this layout, on this
    rank's device of ``mesh``: the card unless the mesh is of CPUs."""
    _check_tp_fsdp(mesh, tc, cfg)
    full = init_train_state(cfg, tc, params=params,
                            device=mesh_mod.mesh_device(mesh, "init_tp_fsdp_train_state"))
    return shard_tp_fsdp_train_state(mesh, full, cfg, tc)


def make_tp_fsdp_train_step(cfg: AssocConfig, tc: TrainConfig, mesh):
    """The TP × FSDP step: ``step_fn(fstate, xs, eps=None) -> (fstate',
    metrics)`` with the contract of the DP × TP step (a rank's rows of each
    global batch over ``data``, ``shard_tp_batch``; ``steps_per_call``
    stacks; ``eps`` this rank's rows of ε) and the state in this layout."""
    n_data, _ = _check_tp_fsdp(mesh, tc, cfg)
    data_group, model_group = mesh.get_group(DATA), mesh.get_group(MODEL)
    # The split leaves' squares sum over both groups, the replicated leaves'
    # over the data group alone (every model rank holds the same slices).
    split = [d is not None for d in tp.tp_param_specs(cfg).values()]
    opt = make_optimizer(tc, slices.split_norm(split, model_group, data_group))
    work = tp.shard_params(mesh, AssocVAE(cfg, device=mesh_mod.mesh_device(mesh)), cfg)
    full = list(work.parameters())
    shapes = [tuple(p.shape) for p in full]
    grads_of = tp.tp_grads(cfg, tc, mesh)

    def one(state, xs, eps):
        with torch.no_grad():  # the TP shard's one all-gather over data
            torch._foreach_copy_(full, slices.gather_full(state.params, shapes, n_data,
                                                          data_group))
        grads, metrics = grads_of(work, state, xs, eps)
        gshards = slices.scatter_mean(grads, n_data, data_group)
        metrics = step_mod.mean_metrics(metrics, data_group)
        metrics["grad_norm"] = opt.norm_fn(gshards)
        opt.update(gshards, state.opt_state, state.params)
        return state._replace(step=state.step + 1), metrics

    return step_mod.stacked_steps(one, tc.steps_per_call)


def tp_fsdp_train_loop(cfg: AssocConfig, tc: TrainConfig, data, mesh, *, epochs: int = 10,
                       state: TrainState | None = None, display_step: int = 1,
                       on_metrics=None, shuffle: bool = True):
    """``dp_train_loop`` with the TP × FSDP step, batches sharded over
    ``data``; ``state`` in this layout."""
    step_fn = make_tp_fsdp_train_step(cfg, tc, mesh)
    return tp.tp_loop(tc, data, mesh, step_fn,
                      init_tp_fsdp_train_state(cfg, tc, mesh) if state is None else state,
                      epochs=epochs, display_step=display_step, on_metrics=on_metrics,
                      shuffle=shuffle)
