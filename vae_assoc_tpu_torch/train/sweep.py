"""E models trained in one batched program (counterpart of
vae_assoc_tpu/train/sweep.py).

A seed ensemble or a hyperparameter sweep of the reference means E runs of
its script, each paying the small towers' underuse of the device again.
Here the E models are one state whose every weight and optimizer tensor
carries a leading [E] model axis, and one step runs all of them:
``torch.func.vmap`` over ``torch.func.grad_and_value`` of the plain
objective (``torch.func.functional_call`` of ``models.assoc.assoc_loss_fn``
on one member's weights, then ``train.step.apply_objective_weights`` with
that member's λ), so the E towers' products become batched products. The
batch is shared (the model axis is the hyperparameter axis, not a data
axis). Swept axes:

- **seed**: each member's initial weights and ε stream, always. Member i
  starts as ``init_train_state`` starts a run with ``seed=seeds[i]``.
- **learning_rate**: the optimizer runs at learning rate 1 and each
  member's update is scaled by its rate (``Optimizer.update(lr_scale=)``),
  as the JAX package scales its Adam direction. Constant schedule only.
- **assoc_lambda**: the objective is rebuilt from its logged terms with
  the member's λ (``apply_objective_weights(assoc_lambda=)``).

**ε.** A step's ε is a pure function of a host integer seed (the Philox
stream, ``ops/sampling.py``), which ``vmap`` cannot batch. So each
member's ε is drawn outside the vmapped function from that member's own
stream, the one its standalone run draws (``models.assoc.modality_seeds``
of ``train.step.step_seed_of_rank(seeds[i], step)``), stacked to
[E, B, n_z] per modality and injected: member i follows its standalone
run.

**The optimizer** is the port's one ``Optimizer``, run on the stacked
tensors: every stage is elementwise but clipping, which takes one norm
per model here (``model_norms``), as ``grad_norm`` does.

``remat`` is refused: ``torch.func`` cannot run activation checkpointing.

**Kernels.** The sweep runs the plain path, as the reference's does
(``use_pallas=False``): ``vmap`` cannot enter the kernels, which run
through ``ctypes``. A ``"conv_pallas"`` tower therefore runs as
``"conv"``, the same function on the plain convs.

**Data parallelism** (``make_dp_sweep_step``): each rank takes its rows of
the global batch, runs the vmapped gradient, and the stacked gradients are
averaged over the data group in one all-reduce after it (a collective
cannot run inside ``vmap``). InfoNCE with global negatives contrasts each
rank's rows with the whole batch, which needs a gather inside the loss:
that step splits the loss at the latent means. The vmapped towers give the
reconstruction and KL terms and the means; the stacked means are
all-gathered over the data group outside ``vmap``; a second vmapped part
computes the association term against them; and the gathered means'
cotangent is reduce-scattered back to the ranks that own the rows (the
transpose of JAX's ``all_gather``) before the towers' backward.

``select_model(state, i)`` is a plain ``TrainState``: it checkpoints
(``utils/checkpoint.py``), evaluates (``train/eval.py``) and serves
(``serve.Predictor.from_model``) like any other.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad_and_value, vjp, vmap

from vae_assoc_tpu_torch.configs import AssocConfig, TrainConfig
from vae_assoc_tpu_torch.models import assoc as assoc_mod
from vae_assoc_tpu_torch.models import vae as vae_mod
from vae_assoc_tpu_torch.models.networks import cuda_or_raise
from vae_assoc_tpu_torch.ops import losses
from vae_assoc_tpu_torch.ops.collectives import all_gather_rows, reduce_scatter_rows
from vae_assoc_tpu_torch.train import step as step_mod
from vae_assoc_tpu_torch.train.loop import _device, _stage
from vae_assoc_tpu_torch.train.step import AdamState, OptState, TrainState, init_train_state


def _sweep_tc(tc: TrainConfig, vary_lr: bool) -> TrainConfig:
    """The TrainConfig the vmapped step runs."""
    if vary_lr and (tc.lr_schedule != "constant" or tc.warmup_steps > 0):
        raise ValueError(
            "per-model learning rates require the constant LR schedule "
            f"with no warmup; got lr_schedule={tc.lr_schedule!r}, "
            f"warmup_steps={tc.warmup_steps}"
        )
    if vary_lr and tc.ema_decay > 0:
        raise ValueError(
            "per-model learning rates are incompatible with ema_decay: "
            "lr scaling happens outside the optimizer chain, so the "
            "in-chain EMA stage would average the UNSCALED updates"
        )
    changes = {}
    if vary_lr:
        changes["learning_rate"] = 1.0  # direction only; scaled per model
    if tc.use_pallas:
        changes["use_pallas"] = False  # see module docstring
    return dataclasses.replace(tc, **changes) if changes else tc


def _sweep_cfg(cfg: AssocConfig) -> AssocConfig:
    """The config the vmapped step runs: a conv-kernel tower on the plain
    convs (module docstring)."""
    if not any(m.encoder == "conv_pallas" for m in cfg.modalities):
        return cfg
    return dataclasses.replace(cfg, modalities=tuple(
        dataclasses.replace(m, encoder="conv") if m.encoder == "conv_pallas" else m
        for m in cfg.modalities))


def _map_module(model: nn.Module, fn) -> nn.Module:
    """A copy of ``model`` whose every parameter p is ``fn(p)``."""
    memo = {id(p): nn.Parameter(fn(p)) for p in model.parameters()}
    return copy.deepcopy(model, memo)


def init_sweep_state(cfg: AssocConfig, tc: TrainConfig, seeds: Sequence[int], *,
                     device="cuda") -> TrainState:
    """E independently seeded TrainStates stacked on a leading model axis:
    member i is ``init_train_state`` of a run with ``seed=seeds[i]``, and
    the state's ``seed`` is the tuple of seeds. On ``device``, the card
    unless the caller names the CPU (without a GPU ``"cuda"`` raises)."""
    seeds = [int(s) for s in seeds]
    if len(seeds) < 1:
        raise ValueError("need at least one seed")
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"duplicate seeds in sweep: {seeds}")
    dev = cuda_or_raise(device, "init_sweep_state")
    tc = _sweep_tc(tc, False)
    members = [init_train_state(cfg, dataclasses.replace(tc, seed=s), device=dev)
               for s in seeds]
    per = [list(m.params.parameters()) for m in members]
    where = {id(p): i for i, p in enumerate(per[0])}
    params = _map_module(members[0].params,
                         lambda p: torch.stack([ps[where[id(p)]].detach() for ps in per]))
    lists = [m.opt_state.lists() for m in members]
    mu, nu, ema, acc = [None if first is None else [torch.stack(ts) for ts in
                                                    zip(*(l[j] for l in lists))]
                        for j, first in enumerate(lists[0])]
    return TrainState(0, params, OptState(AdamState(0, mu, nu), ema=ema, acc=acc),
                      tuple(seeds))


def select_model(state: TrainState, i: int) -> TrainState:
    """Sweep member i as a plain single-model TrainState (copies)."""
    i = int(i)
    return TrainState(state.step, _map_module(state.params, lambda p: p.detach()[i].clone()),
                      state.opt_state.map_lists(lambda l: [t[i].clone() for t in l]),
                      state.seed[i])


def model_norms(tensors) -> torch.Tensor:
    """[E]: each model's global norm over a list of [E, ...] tensors."""
    tensors = list(tensors)
    e = tensors[0].shape[0]
    per = torch.stack([torch.linalg.vector_norm(t.reshape(e, -1), dim=1) for t in tensors])
    return torch.linalg.vector_norm(per, dim=0)


def _check_extras(extras, n_extra: int, state: TrainState) -> None:
    if len(extras) != n_extra:
        raise ValueError(
            f"sweep step built for {n_extra} hyperparameter array(s) "
            f"(lrs, lams as enabled), got {len(extras)}"
        )
    e = len(state.seed)
    for a in extras:
        if tuple(a.shape) != (e,):
            raise ValueError(
                f"hyperparameter arrays must be shape ({e},) — one entry "
                f"per sweep model — got {tuple(a.shape)}"
            )


def _member_eps(state: TrainState, xs, cfg: AssocConfig, group) -> list:
    """Each member's ε from its own stream (the standalone run's), stacked
    to [E, B, n_z] per modality."""
    x0 = assoc_mod.split_cond(xs, cfg)[0][0]
    b, dev, k = x0.shape[0], x0.device, len(cfg.modalities)
    seeds = [assoc_mod.modality_seeds(step_mod.step_seed_of_rank(s, state.step, group), k)
             for s in state.seed]
    return [torch.stack([vae_mod.draw_eps(ms[j], b, m, dev) for ms in seeds])
            for j, m in enumerate(cfg.modalities)]


class _Objective(nn.Module):
    """One member's objective over its weights, for ``functional_call``:
    the whole loss (``whole``), or its two halves around the latent means
    (``towers``, ``assoc``) for global negatives under data parallelism."""

    def __init__(self, cfg: AssocConfig, tc: TrainConfig):
        super().__init__()
        self.model = assoc_mod.AssocVAE(cfg, device="meta")
        self.cfg, self.tc = cfg, tc

    def forward(self, part, *args):
        return getattr(self, part)(*args)

    def whole(self, xs, eps, lam, step):
        tc = self.tc
        total, metrics = assoc_mod.assoc_loss_fn(
            self.model, xs, self.cfg, eps=eps, compute_dtype=tc.compute_dtype,
            parity_mode=tc.parity_mode)
        return step_mod.apply_objective_weights(total, metrics, self.cfg, tc, step, lam)

    def towers(self, xs, eps):
        cfg, tc = self.cfg, self.tc
        k = len(cfg.modalities)
        outs = assoc_mod.assoc_forward(self.model, xs, cfg, eps=eps,
                                       compute_dtype=tc.compute_dtype)
        terms = {}
        for m, x, out in zip(cfg.modalities, xs[:k], outs):
            t = vae_mod.vae_loss(out, x, m, parity_mode=tc.parity_mode)
            terms[f"recon_{m.name}"], terms[f"kl_{m.name}"] = t["recon"], t["kl"]
        return terms, tuple(o.z_mean for o in outs)

    def assoc(self, mus, keys):
        cfg = self.cfg
        mean = losses.ordered_mean if self.tc.parity_mode else torch.mean
        return mean(losses.assoc_loss(list(mus), form=cfg.assoc_form, temp=cfg.assoc_temp,
                                      negatives="global", keys=list(keys)))


def _whole_grads(obj: _Objective, params: dict, xs, eps, lams, step: int):
    """(grads dict, metrics) of every member on the shared batch ``xs``."""

    def member(p, e, lam):
        def loss(p):
            return functional_call(obj, p, ("whole", xs, e, lam, step))

        grads, (_, metrics) = grad_and_value(loss, has_aux=True)(p)
        return grads, metrics

    return vmap(member, in_dims=(0, 0, None if lams is None else 0))(params, eps, lams)


def _global_negative_grads(obj: _Objective, params: dict, xs, eps, lams, step: int, group):
    """``_whole_grads`` for InfoNCE with global negatives under data
    parallelism: the loss split at the latent means, the stacked means
    gathered over ``group`` between its two vmapped halves (module
    docstring). The gradients are this rank's share; their mean over the
    group is the step's gradient."""
    cfg, tc = obj.cfg, obj.tc

    def towers(p):
        return vmap(lambda p, e: functional_call(obj, p, ("towers", xs, e)))(p, eps)

    (terms, mus), towers_vjp = vjp(towers, params)

    def gather(t):  # [E, b, n] on every rank → [E, W·b, n]
        return all_gather_rows(t.transpose(0, 1), group).transpose(0, 1)

    keys = tuple(gather(mu) for mu in mus)
    assoc, assoc_vjp = vjp(vmap(lambda m, k: functional_call(obj, {}, ("assoc", m, k))),
                           mus, keys)
    # The objective from its terms, as the whole loss has it, and its
    # cotangents with respect to them (the total is linear in them).
    leaves = {k: v.detach().requires_grad_() for k, v in terms.items()}
    leaves["assoc"] = assoc.detach().requires_grad_()
    with torch.enable_grad():
        lam = cfg.assoc_lambda if lams is None else lams
        total = step_mod._total_with_lambda(leaves, cfg, lam, 1)
        total, metrics = step_mod.apply_objective_weights(
            total, {**leaves, "total": total}, cfg, tc, step, lams)
        cot = torch.autograd.grad(total.sum(), list(leaves.values()))
    cot = dict(zip(leaves, cot))
    d_mus, d_keys = assoc_vjp(cot.pop("assoc"))
    d_mus = tuple(d + reduce_scatter_rows(k.transpose(0, 1), group).transpose(0, 1)
                  for d, k in zip(d_mus, d_keys))
    (grads,) = towers_vjp((cot, d_mus))
    return grads, {k: v.detach() for k, v in metrics.items()}


def _make_step(cfg: AssocConfig, tc: TrainConfig, *, vary_lr: bool, vary_assoc: bool,
               group=None):
    if tc.remat:
        raise ValueError(
            "the sweep cannot rematerialize its towers: torch.func's grad refuses "
            "activation checkpointing (its saved-tensor hooks). remat=False computes "
            "the same gradients, keeping the activations."
        )
    tc_run = _sweep_tc(tc, vary_lr)
    cfg_run = _sweep_cfg(cfg)
    opt = step_mod.make_optimizer(tc_run, model_norms)
    n_extra = int(vary_lr) + int(vary_assoc)
    split = (group is not None and cfg.assoc_form == "infonce"
             and cfg.assoc_negatives == "global")
    obj = _Objective(cfg_run, tc_run)

    def step_fn(state, xs, *extras, eps=None):
        _check_extras(extras, n_extra, state)
        it = iter(extras)
        lrs = next(it) if vary_lr else None
        lams = next(it) if vary_assoc else None

        def one(state, xs, eps):
            xs = list(xs)
            if eps is None:
                eps = _member_eps(state, xs, cfg, group)
            names = [k for k, _ in state.params.named_parameters()]
            plist = list(state.params.parameters())
            pdict = {"model." + k: p.detach() for k, p in zip(names, plist)}
            if split:
                grads, metrics = _global_negative_grads(obj, pdict, xs, eps, lams,
                                                        state.step, group)
            else:
                grads, metrics = _whole_grads(obj, pdict, xs, eps, lams, state.step)
            grads = [grads["model." + k] for k in names]
            e = len(state.seed)
            metrics = {k: v.detach().expand(e) for k, v in metrics.items()}
            if group is not None:
                grads = step_mod.all_reduce_mean(grads, group)
                keys = list(metrics)
                vals = step_mod.all_reduce_mean([torch.stack([metrics[k] for k in keys])],
                                                group)[0]
                metrics = dict(zip(keys, vals.unbind()))
            metrics["grad_norm"] = model_norms(grads)
            opt.update(grads, state.opt_state, plist, lr_scale=lrs)
            return state._replace(step=state.step + 1), metrics

        return step_mod.stacked_steps(one, tc.steps_per_call)(state, xs, eps)

    return step_fn


def make_sweep_step(cfg: AssocConfig, tc: TrainConfig, *, vary_lr: bool = False,
                    vary_assoc: bool = False):
    """The vmapped E-model step: ``step_fn(state, xs, *extras, eps=None) ->
    (state', metrics)``. ``state`` is an ``init_sweep_state``; ``xs`` the
    usual per-modality batches, shared by every model; ``extras`` one [E]
    float tensor per enabled flag, the learning rates and then the λs;
    ``eps`` optionally one [E, B, n_z] tensor per modality in place of the
    members' own streams. Every metric comes back [E]. With
    ``tc.steps_per_call`` N > 1, ``xs`` (and ``eps``) hold [N, ...] stacks
    that run back to back (``train.step.stacked_steps``) and the metrics
    come back [N, E]."""
    return _make_step(cfg, tc, vary_lr=vary_lr, vary_assoc=vary_assoc)


def make_dp_sweep_step(cfg: AssocConfig, tc: TrainConfig, mesh, *, vary_lr: bool = False,
                       vary_assoc: bool = False):
    """The data-parallel sweep over the first axis of ``mesh``:
    ``make_sweep_step``'s contract with ``xs`` (and ``eps``) this rank's rows
    of each global batch (``parallel.shard_batch``) and the state
    replicated (``init_dp_sweep_state``). The stacked gradients are averaged
    over the data group in one all-reduce; each rank folds its rank into
    its members' ε seeds, as the DP step does."""
    from vae_assoc_tpu_torch.parallel.dp import batch_group

    return _make_step(cfg, tc, vary_lr=vary_lr, vary_assoc=vary_assoc,
                      group=batch_group(mesh))


def init_dp_sweep_state(cfg: AssocConfig, tc: TrainConfig, mesh,
                        seeds: Sequence[int]) -> TrainState:
    """An ``init_sweep_state`` on this rank's device of ``mesh`` (the card
    unless the mesh is of CPUs), replicated from the mesh's first rank."""
    from vae_assoc_tpu_torch.parallel import mesh as mesh_mod

    state = init_sweep_state(cfg, tc, seeds,
                             device=mesh_mod.mesh_device(mesh, "init_dp_sweep_state"))
    return mesh_mod.replicate(mesh, state)


def sweep_loop(cfg: AssocConfig, tc: TrainConfig, data, *, seeds: Sequence[int],
               learning_rates: Optional[Sequence[float]] = None,
               assoc_lambdas: Optional[Sequence[float]] = None, epochs: int = 10,
               state: Optional[TrainState] = None, display_step: int = 1,
               on_metrics: Optional[Callable[[int, dict], None]] = None,
               shuffle: bool = True, device=None):
    """Train E models over the same paired data, ``train_loop``'s contract
    with a model axis: the data staged on the device once, each epoch's
    permutation from ``np.random.default_rng([tc.seed, start_step])`` (so
    every model sees ``train_loop``'s batches in its order), and history
    entries mapping each metric to an [E] numpy array of its epoch mean,
    with ``samples_per_sec`` (each model's rate) and
    ``sweep_model_samples_per_sec`` (E times it). ``device`` as
    ``train_loop``'s.

    Returns ``(state, history)``; pick a winner with
    ``select_model(state, int(np.argmin(history[-1]["total"])))``."""
    e = len(seeds)
    for name, arr in (("learning_rates", learning_rates),
                      ("assoc_lambdas", assoc_lambdas)):
        if arr is not None and len(arr) != e:
            raise ValueError(
                f"{name} must have one entry per seed ({e}), got {len(arr)}"
            )
    n = data[0].shape[0]
    for k, d in enumerate(data):
        if d.shape[0] != n:
            raise ValueError(f"modality {k} has {d.shape[0]} rows, expected {n}")
    bs, spc = tc.batch_size, tc.steps_per_call
    nb = n // bs
    if nb == 0:
        raise ValueError(f"batch_size {bs} > dataset size {n}")
    n_calls = nb // spc
    if n_calls == 0:
        raise ValueError(f"steps_per_call {spc} > batches/epoch {nb}")

    dev = _device(state, data, device, "sweep_loop")
    dev_data = _stage(data, dev)
    if state is None:
        state = init_sweep_state(cfg, tc, seeds, device=dev)
    extras = [torch.tensor(a, dtype=torch.float32, device=dev)
              for a in (learning_rates, assoc_lambdas) if a is not None]
    step_fn = make_sweep_step(cfg, tc, vary_lr=learning_rates is not None,
                              vary_assoc=assoc_lambdas is not None)
    shuffle_rng = np.random.default_rng([tc.seed, int(state.step)])
    used = n_calls * spc * bs

    history = []
    for epoch in range(epochs):
        perm = shuffle_rng.permutation(n) if shuffle else np.arange(n)
        idx = torch.as_tensor(perm[:used].reshape(n_calls, spc, bs), dtype=torch.int64,
                              device=dev)
        stacks = [a[idx] for a in dev_data]
        t0 = time.perf_counter()
        acc = []
        for c in range(n_calls):
            xs = [s[c] if spc > 1 else s[c, 0] for s in stacks]
            state, metrics = step_fn(state, xs, *extras)
            acc.append(metrics)
        keys = list(acc[0])
        # [n_calls, keys, N, E] → the epoch mean per model, one host copy.
        host = torch.stack([torch.stack([m[k].reshape(-1, e) for k in keys]) for m in acc])
        host = host.cpu().numpy()
        dt = time.perf_counter() - t0
        mean_metrics = {k: host[:, i].mean(axis=(0, 1)) for i, k in enumerate(keys)}
        mean_metrics["samples_per_sec"] = np.full(e, used / dt)
        mean_metrics["sweep_model_samples_per_sec"] = np.full(e, used * e / dt)
        history.append(mean_metrics)
        if on_metrics is not None and epoch % display_step == 0:
            on_metrics(epoch, mean_metrics)
    return state, history


__all__ = [
    "init_dp_sweep_state",
    "init_sweep_state",
    "make_dp_sweep_step",
    "make_sweep_step",
    "model_norms",
    "select_model",
    "sweep_loop",
]
