"""ZeRO-sharded data parallelism that keeps the kernels (counterpart of
vae_assoc_tpu/parallel/zero.py).

- **Storage.** Every parameter and Adam-moment leaf (and the EMA and the
  gradient accumulator, where the train config has them) is flattened,
  zero-padded to a multiple of the mesh size W and cut into W slices; rank
  r stores slice r (``parallel/slices.py``). That is the JAX layout
  (``_flatten_pad``), so rank r's
  slices equal the JAX state's shard r value for value. A rank's state
  memory drops by W.
- **The step.** One ``all_gather`` of every rank's slices, in one bucket,
  fills a full-shape model that the step keeps (the transient weights);
  the unchanged model path runs on it, on the rank's rows of the batch,
  every ``use_pallas`` setting and both conv towers included; one
  ``reduce_scatter`` of the gradients, in one bucket, leaves each rank the
  sum of its slice, which is divided by W; Adam (the port's
  ``Optimizer``) updates the local flat slices, its arithmetic being
  elementwise. Per step the wire carries the parameters once gathered and
  once scattered: plain DP's all-reduce, decomposed.
- **Clipping** compares the norm of the whole gradient, summed over the
  group (``slices.sharded_norm``), as the JAX package's
  ``_clip_by_global_norm_sharded``; ``accum_steps`` and ``ema_decay``
  compose, elementwise on the slices.

The gradient semantics are DP's (``parallel/dp.py``): the rank folds into
the ε seed, global InfoNCE negatives are gathered over the data group, and
the summed gradient is that of the global batch's mean loss.

A rank holds only its slices, so ``gather_zero_train_state`` is a
collective over the mesh (the JAX arrays are global, so there it is a
reshape), and ``shard_zero_train_state`` cuts a whole state that every
rank holds (a fresh one, or one restored from a checkpoint). A checkpoint
of a ZeRO state is the whole state of ``gather_zero_train_state``, the
layout ``utils/checkpoint.save`` writes; it restores into any layout.
"""

from __future__ import annotations

import torch

from vae_assoc_tpu_torch.configs import AssocConfig, TrainConfig
from vae_assoc_tpu_torch.models import assoc as assoc_mod
from vae_assoc_tpu_torch.parallel import mesh as mesh_mod
from vae_assoc_tpu_torch.parallel import slices
from vae_assoc_tpu_torch.parallel.dp import _epoch_loop
from vae_assoc_tpu_torch.train import step as step_mod
from vae_assoc_tpu_torch.train.step import TrainState, init_train_state, make_optimizer


def _n_shards(mesh) -> int:
    if mesh_mod.DATA_AXIS not in mesh.mesh_dim_names:
        raise ValueError(
            f"ZeRO shards over the '{mesh_mod.DATA_AXIS}' axis; mesh has "
            f"{mesh.mesh_dim_names}"
        )
    if mesh.ndim != 1:
        raise ValueError(
            "ZeRO runs over a 1-D data mesh (it owns the whole layout); got a "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} mesh. For model-axis "
            "splits use parallel/tp.py."
        )
    return mesh.size()


def shard_zero_train_state(mesh, state: TrainState, cfg: AssocConfig,
                           tc: TrainConfig) -> TrainState:
    """A whole TrainState, the same on every rank, → the ZeRO layout: this
    rank's flat padded slice of every parameter and optimizer list, on the
    state's device; the step, the seed and the optimizer's counts as they
    are."""
    n = _n_shards(mesh)
    r = mesh.get_local_rank(mesh_mod.DATA_AXIS)

    def cut(ts):
        return [slices.cut(t, n, r) for t in ts]

    return TrainState(state.step, cut(state.params.parameters()),
                      state.opt_state.map_lists(cut), state.seed)


@torch.no_grad()
def gather_zero_train_state(zstate: TrainState, cfg: AssocConfig, tc: TrainConfig,
                            mesh) -> TrainState:
    """Inverse of :func:`shard_zero_train_state`, on every rank: a whole
    TrainState that checkpoints, evaluates and serves like any. A
    collective over ``mesh`` (every rank calls it); one all-gather."""
    n = _n_shards(mesh)
    group = mesh.get_group(mesh_mod.DATA_AXIS)
    dev = zstate.params[0].device
    model = assoc_mod.AssocVAE(cfg, device=dev)
    shapes = [tuple(p.shape) for p in model.parameters()]
    lists = [zstate.params] + [l for l in zstate.opt_state.lists() if l is not None]
    full = slices.gather_full([t for l in lists for t in l], shapes * len(lists), n, group)
    per = [full[i * len(shapes):(i + 1) * len(shapes)] for i in range(len(lists))]
    torch._foreach_copy_(list(model.parameters()), per[0])
    it = iter(per[1:])
    opt = zstate.opt_state.map_lists(lambda _: [t.clone() for t in next(it)])
    return TrainState(zstate.step, model, opt, zstate.seed)


def init_zero_train_state(cfg: AssocConfig, tc: TrainConfig, mesh, *,
                          params=None) -> TrainState:
    """Step 0 (from ``tc.seed``, or ``params``) in the ZeRO layout, on this
    rank's device of ``mesh``: the card unless the mesh is of CPUs."""
    _n_shards(mesh)
    full = init_train_state(cfg, tc, device=mesh_mod.mesh_device(mesh, "init_zero_train_state"),
                             params=params)
    return shard_zero_train_state(mesh, full, cfg, tc)


def make_zero_train_step(cfg: AssocConfig, tc: TrainConfig, mesh):
    """The ZeRO step: ``step_fn(zstate, xs, eps=None) -> (zstate', metrics)``
    with the contract of ``make_dp_train_step`` (this rank's rows of each
    global batch, ``steps_per_call`` stacks, ``eps`` this rank's rows of ε)
    and the state in the ZeRO layout. Every kernel path runs."""
    n = _n_shards(mesh)
    group = mesh.get_group(mesh_mod.DATA_AXIS)
    opt = make_optimizer(tc, slices.sharded_norm(group))
    work = assoc_mod.AssocVAE(cfg, device=mesh_mod.mesh_device(mesh))
    full = list(work.parameters())
    shapes = [tuple(p.shape) for p in full]

    def one(state, xs, eps):
        with torch.no_grad():  # the weights' one all-gather
            torch._foreach_copy_(full, slices.gather_full(state.params, shapes, n, group))
        total, metrics = assoc_mod.assoc_loss_fn(
            work, list(xs), cfg,
            seed=step_mod.step_seed_of_rank(state.seed, state.step, group)
            if eps is None else None,
            eps=eps, compute_dtype=tc.compute_dtype, parity_mode=tc.parity_mode,
            use_pallas=tc.use_pallas, remat=tc.remat, data_group=group,
        )
        total, metrics = step_mod.apply_objective_weights(total, metrics, cfg, tc, state.step)
        # The gradients' one reduce-scatter: each rank keeps the mean of its slices.
        gshards = slices.scatter_mean(torch.autograd.grad(total, full), n, group)
        metrics = step_mod.mean_metrics({k: v.detach() for k, v in metrics.items()}, group)
        metrics["grad_norm"] = opt.norm_fn(gshards)
        opt.update(gshards, state.opt_state, state.params)
        return state._replace(step=state.step + 1), metrics

    return step_mod.stacked_steps(one, tc.steps_per_call)


def zero_train_loop(cfg: AssocConfig, tc: TrainConfig, data, mesh, *, epochs: int = 10,
                    state: TrainState | None = None, display_step: int = 1,
                    on_metrics=None, shuffle: bool = True):
    """``dp_train_loop`` with the ZeRO step; ``state`` in the ZeRO layout
    (``init_zero_train_state`` / ``shard_zero_train_state``)."""
    n = _n_shards(mesh)
    if state is None:
        state = init_zero_train_state(cfg, tc, mesh)
    return _epoch_loop(tc, data, mesh, make_zero_train_step(cfg, tc, mesh), state,
                       shard=(mesh.get_local_rank(mesh_mod.DATA_AXIS), n), epochs=epochs,
                       display_step=display_step, on_metrics=on_metrics, shuffle=shuffle)
