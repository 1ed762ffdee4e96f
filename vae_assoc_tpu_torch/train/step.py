"""The train step (counterpart of vae_assoc_tpu/train/step.py).

One step computes the joint objective, its gradients with respect to the
weights, and the optimizer update, all enqueued on the params' device with
no host synchronisation. The weights and the optimizer state are updated in
place (the JAX package donates its buffers to the same end).

The step's per-step values (each modality's ε seed, Adam's learning rate and
bias corrections, the annealing weights) are computed on the host, in the
same fp32 arithmetic either way, and reach the step as host integers and
floats, or as device tensors (:class:`StepScalars`, rows from
:func:`step_scalar_rows`): then the step reads nothing from the host, and
``train_loop_fused`` captures it in a CUDA graph and replays it. The
counters (``TrainState.step``, Adam's ``count``, ``ema_count``) stay host
integers either way.

``make_optimizer`` is the one optimizer source and follows optax's chain of
vae_assoc_tpu/train/step.py::make_optimizer operation for operation —
[MultiSteps(accum_steps) ∘] [clip_by_global_norm ∘] Adam (TF defaults) ∘
learning rate (constant, or cosine, after a linear warmup) [∘ EMA] — so
both packages agree to fp32 rounding from the same gradients. The port's
own stages (configs.PORT_TRAIN_FIELDS, Sketch-RNN's training): clipping by
value before the chain, an exponential learning rate, and the annealed KL
weight of a sketch modality (``objective_scalars``).
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from vae_assoc_tpu_torch.configs import AssocConfig, TrainConfig
from vae_assoc_tpu_torch.models import assoc as assoc_mod
from vae_assoc_tpu_torch.models.networks import cuda_or_raise
from vae_assoc_tpu_torch.ops.sampling import fold_in, seed_bits
from vae_assoc_tpu_torch.utils import spans


class AdamState:
    """optax ScaleByAdamState: ``count`` updates so far, moments ``mu``, ``nu``."""

    def __init__(self, count: int, mu: list, nu: list):
        self.count, self.mu, self.nu = count, mu, nu


class OptState:
    """The optimizer's state. ``adam``; ``ema``/``ema_count`` when
    ema_decay > 0; the gradient accumulator ``acc`` and its ``mini_step``
    when accum_steps > 1 (optax MultiStepsState)."""

    def __init__(self, adam: AdamState, ema=None, acc=None):
        self.adam = adam
        self.ema, self.ema_count = ema, 0
        self.acc, self.mini_step = acc, 0

    def lists(self) -> list:
        """The parameter-shaped lists in a fixed order: Adam's ``mu`` and
        ``nu``, ``ema`` and ``acc`` (None where the config has no such stage)."""
        return [self.adam.mu, self.adam.nu, self.ema, self.acc]

    def map_lists(self, fn) -> "OptState":
        """A new state holding ``fn(list)`` for each of :meth:`lists` (called
        in that order; None stays None), the counts as they are: how the
        parallel layouts re-lay the optimizer state with the weights."""
        mu, nu, ema, acc = [None if l is None else fn(l) for l in self.lists()]
        out = OptState(AdamState(self.adam.count, mu, nu), ema=ema, acc=acc)
        out.ema_count, out.mini_step = self.ema_count, self.mini_step
        return out


class TrainState(NamedTuple):
    step: int  # micro-steps taken
    params: assoc_mod.AssocVAE
    opt_state: OptState
    seed: int  # the ε stream's seed (tc.seed)


def lr_at(tc: TrainConfig, count: int) -> np.float32:
    """The learning rate of the ``count``-th optimizer update, in fp32 as
    optax's schedules compute it (linear warmup joined to a constant or a
    cosine decay), or Sketch-RNN's exponential decay toward
    ``min_learning_rate``."""
    f32 = np.float32
    if tc.lr_schedule not in ("constant", "cosine", "exponential"):
        raise ValueError(
            f"unknown lr_schedule {tc.lr_schedule!r}; expected 'constant', 'cosine' "
            "or 'exponential'"
        )
    if tc.lr_schedule == "exponential" and not 0.0 < tc.lr_decay_rate <= 1.0:
        raise ValueError(
            f"lr_schedule='exponential' needs lr_decay_rate in (0, 1], got {tc.lr_decay_rate}"
        )
    if tc.lr_schedule == "cosine" and tc.decay_steps <= 0:
        raise ValueError(
            "lr_schedule='cosine' needs decay_steps > 0 (the decay horizon in "
            f"optimizer updates), got {tc.decay_steps}"
        )

    def main(c):
        if tc.lr_schedule == "constant":
            return f32(tc.learning_rate)
        if tc.lr_schedule == "exponential":  # in double, as sketch_rnn_train.py
            lo = tc.min_learning_rate
            return f32((tc.learning_rate - lo) * tc.lr_decay_rate ** int(c) + lo)
        c = min(f32(c), f32(tc.decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(tc.decay_steps)))
        return f32(tc.learning_rate) * (f32(1 - tc.lr_end_factor) * cosine
                                        + f32(tc.lr_end_factor))

    w = tc.warmup_steps
    if w <= 0:
        return main(count)
    if count < w:
        frac = f32(1) - f32(min(max(count, 0), w)) / f32(w)
        return f32(-tc.learning_rate) * frac + f32(tc.learning_rate)
    return main(count - w)


def adam_scalars(tc: TrainConfig, count: int) -> tuple:
    """(−lr, 1/bc1, 1/bc2) in fp32 of the update that follows ``count``
    updates: the learning rate ``lr_at(tc, count)`` and the reciprocals of
    Adam's bias corrections bc = 1 − b^(count + 1). The update multiplies
    by the reciprocals, which is what CUDA's division by a host scalar
    does; by a device scalar it would divide."""
    f32 = np.float32
    n = f32(count + 1)
    return (-lr_at(tc, count), f32(1) / (f32(1) - f32(tc.adam_b1) ** n),
            f32(1) / (f32(1) - f32(tc.adam_b2) ** n))


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) over a list of tensors, on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer:
    """Adam with optional clipping, schedule, accumulation and EMA, as
    optax's chain in the JAX package's make_optimizer. ``update`` applies
    the step to the weights in place and advances the state in place.

    ``norm_fn`` computes the norm that clipping compares with
    ``grad_clip_norm`` (``global_norm`` by default); a layout whose
    gradients are shards passes the norm of the whole gradient, as the JAX
    package's layouts pass their ``clip_transform``. Every other stage is
    elementwise, so it runs as well on shards as on whole tensors, and on
    the [E, ...] stacks of a sweep state (train/sweep.py), whose
    ``norm_fn`` returns one norm per model."""

    def __init__(self, tc: TrainConfig, norm_fn=global_norm):
        if tc.ema_decay > 0 and not 0.0 < tc.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {tc.ema_decay}")
        if tc.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
        if tc.grad_clip_value < 0:
            raise ValueError(f"grad_clip_value must be >= 0, got {tc.grad_clip_value}")
        lr_at(tc, 0)  # validates the schedule
        self.tc = tc
        self.norm_fn = norm_fn

    def init(self, params) -> OptState:
        params = list(params)

        def zeros():
            return [torch.zeros_like(p, memory_format=torch.contiguous_format)
                    for p in params]

        return OptState(
            AdamState(0, zeros(), zeros()),
            ema=zeros() if self.tc.ema_decay > 0 else None,
            acc=zeros() if self.tc.accum_steps > 1 else None,
        )

    @torch.no_grad()
    def update(self, grads, state: OptState, params, *, lr_scale=None,
               scalars=None) -> None:
        """``lr_scale``: an [E] tensor scaling each model's update of a sweep
        state, the JAX package's per-model learning rate (``_one_step``'s
        ``lr_scale``), with the optimizer built at learning_rate 1.
        ``scalars``: this update's (−lr, 1/bc1, 1/bc2), ``adam_scalars`` of
        ``state.adam.count``, as an fp32 tensor [3] on the device, which the
        update then reads in place of host floats (accum_steps 1 only)."""
        grads, params = list(grads), list(params)
        k = self.tc.accum_steps
        if k == 1:
            self._inner(grads, state, params, lr_scale, scalars)
            return
        if scalars is not None:
            raise ValueError("device step scalars need accum_steps == 1")
        # MultiSteps: a running mean of k micro-batch grads (Welford), one
        # inner update when the k-th arrives; the weights hold still between.
        diff = torch._foreach_sub(grads, state.acc)
        torch._foreach_div_(diff, float(state.mini_step + 1))
        torch._foreach_add_(state.acc, diff)
        if state.mini_step == k - 1:
            self._inner(state.acc, state, params, lr_scale)
            torch._foreach_zero_(state.acc)
        state.mini_step = (state.mini_step + 1) % k

    def count_update(self, state: OptState) -> None:
        """The host side of one inner update: Adam's ``count`` and, with an
        EMA, ``ema_count`` advance by one. ``_inner`` calls it; so does a
        replay of a captured update, whose device work the graph does."""
        state.adam.count += 1
        if state.ema is not None:
            state.ema_count += 1

    def _inner(self, grads, state: OptState, params, lr_scale=None, scalars=None) -> None:
        tc = self.tc
        if tc.grad_clip_value > 0:  # each element to ±value, before the norm
            grads = torch._foreach_clamp_max(
                torch._foreach_clamp_min(grads, -tc.grad_clip_value), tc.grad_clip_value)
        if tc.grad_clip_norm > 0:
            norm, clip = self.norm_fn(grads), tc.grad_clip_norm
            if norm.dim() == 0:
                keep = norm < clip
                scaled = torch._foreach_div(grads, norm)
                torch._foreach_mul_(scaled, clip)
                grads = [torch.where(keep, g, s) for g, s in zip(grads, scaled)]
            else:  # one norm per model of a sweep state's [E, ...] stacks
                views = [norm.view((-1,) + (1,) * (g.dim() - 1)) for g in grads]
                grads = [torch.where(n < clip, g, g / n * clip) for g, n in zip(grads, views)]
        a = state.adam
        b1, b2 = tc.adam_b1, tc.adam_b2
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g² + b2 nu
        t = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_mul_(a.mu, b1)
        torch._foreach_add_(a.mu, t)
        t = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(t, 1 - b2)
        torch._foreach_mul_(a.nu, b2)
        torch._foreach_add_(a.nu, t)
        if scalars is None:
            neg_lr, inv_bc1, inv_bc2 = (float(v) for v in adam_scalars(tc, a.count))
        else:
            neg_lr, inv_bc1, inv_bc2 = scalars.unbind()
        self.count_update(state)
        # u = -lr · m̂ / (√v̂ + eps), m̂ = mu / bc1, v̂ = nu / bc2
        den = torch._foreach_mul(a.nu, inv_bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, tc.adam_eps)
        upd = torch._foreach_mul(a.mu, inv_bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, neg_lr)
        if lr_scale is not None:
            for u in upd:
                u.mul_(lr_scale.view((-1,) + (1,) * (u.dim() - 1)))
        if state.ema is not None:
            # EMA of the post-update weights, last in the chain.
            new_p = torch._foreach_add(params, upd)
            torch._foreach_mul_(state.ema, tc.ema_decay)
            torch._foreach_mul_(new_p, 1.0 - tc.ema_decay)
            torch._foreach_add_(state.ema, new_p)
        torch._foreach_add_(params, upd)


def make_optimizer(tc: TrainConfig, norm_fn=global_norm) -> Optimizer:
    """The one optimizer source (see module docstring); ``norm_fn`` as
    :class:`Optimizer`'s."""
    return Optimizer(tc, norm_fn)


def ema_params(tc: TrainConfig, opt_state: OptState):
    """Debiased EMA weights (a list in parameter order), or None when
    ``tc.ema_decay == 0``."""
    if tc.ema_decay <= 0:
        return None
    if opt_state.ema is None:
        raise ValueError("this optimizer state was built with ema_decay == 0")
    c = opt_state.ema_count
    corr = 1.0 if c == 0 else float(np.float32(1) - np.float32(tc.ema_decay) ** np.float32(c))
    return [e / corr for e in opt_state.ema]


def eval_params(tc: TrainConfig, state: TrainState) -> assoc_mod.AssocVAE:
    """The weights evaluation should use, as a module the verbs take: a
    copy holding the debiased EMA weights when ``ema_decay > 0`` and at
    least one optimizer update has run, else the live ``state.params``."""
    if tc.ema_decay <= 0 or state.opt_state.ema_count == 0:
        return state.params
    model = copy.deepcopy(state.params)
    with torch.no_grad():
        torch._foreach_copy_(list(model.parameters()), ema_params(tc, state.opt_state))
    return model


def init_train_state(cfg: AssocConfig, tc: TrainConfig, *, device="cuda",
                     params=None) -> TrainState:
    """Step 0: Xavier weights from ``tc.seed`` (or ``params``), a fresh
    optimizer state, and the ε stream keyed by ``tc.seed``. The weights go
    to ``device``, the card unless the caller names the CPU; without a GPU
    ``device="cuda"`` raises."""
    if params is None:
        params = assoc_mod.init_assoc(tc.seed, cfg, device=cuda_or_raise(device, "init_train_state"))
    return TrainState(0, params, make_optimizer(tc).init(params.parameters()), tc.seed)


def _total_with_lambda(metrics: dict, cfg: AssocConfig, lam, kl_w, sketch_w=None):
    """Σ_k (recon_k + w_k·kl_k) + lam·assoc from the logged terms; the
    gradient is exact, as the total is linear in them. w_k is ``kl_w``, or
    for the i-th sketch modality ``sketch_w[i]`` (its ``kl_weight`` where
    ``sketch_w`` is None). ``lam``, ``kl_w`` and each of ``sketch_w`` are
    numbers, or tensors (a sweep member's own λ under ``vmap``; a step's
    weights in device memory)."""
    total = torch.zeros((), dtype=torch.float32, device=metrics["assoc"].device)
    if not isinstance(kl_w, torch.Tensor):
        kl_w = float(kl_w)
    sketch_w = iter(() if sketch_w is None else sketch_w)
    for m in cfg.modalities:
        w = next(sketch_w, m.kl_weight) if m.is_sketch else kl_w
        if not isinstance(w, torch.Tensor):
            w = float(w)
        total = total + metrics[f"recon_{m.name}"] + w * metrics[f"kl_{m.name}"]
    if not isinstance(lam, torch.Tensor):
        lam = float(np.float32(lam))
    return total + lam * metrics["assoc"]


def objective_weights(tc: TrainConfig, step: int):
    """(kl_weight, assoc_scale) of the annealed objective at micro-step
    ``step``, or None when every knob is at its default (the objective then
    stays exactly assoc_loss_fn's). Ramps count optimizer updates
    u = step // accum_steps: β(u) = kl_beta·min(1, u/N_kl),
    s(u) = min(1, u/N_assoc)."""
    if tc.kl_beta == 1.0 and tc.kl_anneal_steps == 0 and tc.assoc_warmup_steps == 0:
        return None
    if tc.kl_beta < 0:
        raise ValueError(f"kl_beta must be >= 0, got {tc.kl_beta}")
    if tc.kl_anneal_steps < 0 or tc.assoc_warmup_steps < 0:
        raise ValueError(
            "annealing horizons must be >= 0, got "
            f"kl_anneal_steps={tc.kl_anneal_steps}, "
            f"assoc_warmup_steps={tc.assoc_warmup_steps}"
        )
    f32 = np.float32
    u = f32(step // tc.accum_steps)
    kl_w = f32(tc.kl_beta)
    if tc.kl_anneal_steps > 0:
        kl_w = kl_w * min(f32(1), u / f32(tc.kl_anneal_steps))
    scale = f32(1)
    if tc.assoc_warmup_steps > 0:
        scale = min(f32(1), u / f32(tc.assoc_warmup_steps))
    return kl_w, scale


def sketch_kl_weights(cfg: AssocConfig, tc: TrainConfig, step: int) -> tuple:
    """Each sketch modality's KL weight at micro-step ``step`` in fp32, in
    the order of the modalities: w(u) = kl_weight − (kl_weight −
    kl_weight_start)·kl_decay_rate^u over optimizer updates u = step //
    accum_steps (sketch_rnn_train.py), or its ``kl_weight`` where its
    ``kl_decay_rate`` is 0. Computed in double, as sketch_rnn_train.py
    does, and rounded to fp32."""
    u = int(step) // tc.accum_steps
    return tuple(np.float32(m.kl_weight - (m.kl_weight - m.kl_weight_start)
                            * m.kl_decay_rate ** u if m.kl_decay_rate > 0 else m.kl_weight)
                 for m in cfg.modalities if m.is_sketch)


def objective_scalars(cfg: AssocConfig, tc: TrainConfig, step: int):
    """(kl_weight, λ·assoc_scale, assoc_scale, *sketch KL weights) in fp32
    at micro-step ``step``, the weights ``apply_objective_weights`` puts in
    the objective, or None where ``objective_weights`` is None and the
    config has no sketch modality."""
    w = objective_weights(tc, step)
    sketch = sketch_kl_weights(cfg, tc, step)
    if w is None and not sketch:
        return None
    kl_w, scale = (np.float32(1), np.float32(1)) if w is None else w
    return (kl_w, scale * np.float32(cfg.assoc_lambda), scale) + sketch


def apply_objective_weights(total, metrics, cfg: AssocConfig, tc: TrainConfig,
                            step: int, assoc_lambda=None, weights=None):
    """Rebuild (total, metrics) with the β-VAE and annealing knobs' runtime
    weights and ``assoc_lambda``, a per-model λ in place of the config's
    (an [E] entry of a sweep, a tensor under ``vmap``). ``weights``: the
    step's ``objective_scalars`` as an fp32 tensor on the device, read
    in place of host floats. Returns the inputs untouched when none is
    active."""
    w = objective_scalars(cfg, tc, step)
    if w is None and assoc_lambda is None:
        return total, metrics
    if w is None:
        total = _total_with_lambda(metrics, cfg, assoc_lambda, np.float32(1))
        return total, {**metrics, "total": total}
    if weights is not None:
        if assoc_lambda is not None:
            raise ValueError("device objective weights take the config's assoc_lambda")
        kl_w, lam, scale, *sketch = weights.unbind()
    else:
        kl_w, lam, scale, *sketch = w
        if assoc_lambda is not None:
            lam = assoc_lambda * float(scale)
        kl_w, scale = (torch.tensor(float(v), device=total.device) for v in (kl_w, scale))
    total = _total_with_lambda(metrics, cfg, lam, kl_w, sketch)
    return total, {**metrics, "total": total, "kl_beta_eff": kl_w, "assoc_scale_eff": scale}


class StepScalars(NamedTuple):
    """A step's per-step values in device memory, views of one int64 row of
    :func:`step_scalar_rows`: ``seeds`` [k] int64, each modality's ε seed
    (its 64 bits, ``ops.sampling.seed_bits``); ``adam`` [3] fp32,
    ``adam_scalars`` (the learning rate's schedule among them); ``objective``
    [n] fp32, ``objective_scalars`` (n = :func:`objective_width`: 3, and one
    more for each sketch modality's KL weight), or None where n is 0."""

    seeds: torch.Tensor
    adam: torch.Tensor
    objective: torch.Tensor | None

    @staticmethod
    def width(k: int, objective: int) -> int:
        """Words of a row: k seeds, then 3 + ``objective`` fp32 values two
        to a word."""
        return k + (4 + objective) // 2

    @classmethod
    def of_row(cls, row: torch.Tensor, k: int, objective: int) -> "StepScalars":
        f = row[k:].view(torch.float32)
        return cls(row[:k], f[:3], f[3:3 + objective] if objective else None)


def objective_width(cfg: AssocConfig, tc: TrainConfig) -> int:
    """The number of objective weights a step's scalars carry: 0 where
    ``objective_scalars`` is None (at every step or at none), else its
    length."""
    w = objective_scalars(cfg, tc, 0)
    return 0 if w is None else len(w)


def step_scalar_rows(state: TrainState, cfg: AssocConfig, tc: TrainConfig,
                     steps: int) -> np.ndarray:
    """[steps, width] int64 rows of :class:`StepScalars` (``of_row(row, k,
    objective_width(cfg, tc))``): row s holds those of
    micro-step ``state.step + s``, whose update follows
    ``state.opt_state.adam.count + s`` updates (accum_steps 1), computed as
    the step computes them from host values; the fp32 values sit as their
    bits, two to a word."""
    k = len(cfg.modalities)
    obj = objective_width(cfg, tc)
    rows = np.empty((steps, StepScalars.width(k, obj)), np.int64)
    floats = np.zeros((steps, 2 * (rows.shape[1] - k)), np.float32)
    for s in range(steps):
        step = state.step + s
        seeds = assoc_mod.modality_seeds(step_seed(state.seed, step), k)
        rows[s, :k] = [seed_bits(x) for x in seeds]
        floats[s, :3] = adam_scalars(tc, state.opt_state.adam.count + s)
        if obj:
            floats[s, 3:3 + obj] = objective_scalars(cfg, tc, step)
    rows[:, k:] = floats.view(np.int64)
    return rows


def step_seed(seed: int, step: int) -> int:
    """The ε seed of micro-step ``step``; each modality folds in its index
    (models/assoc.modality_seeds)."""
    return fold_in(seed, step)


def step_seed_of_rank(seed: int, step: int, group=None) -> int:
    """The ε seed of micro-step ``step`` on this process: ``step_seed``, with
    the rank in ``group`` folded in where a data-parallel group shards the
    batch (the JAX package folds the mesh position, ``axis_index``), so
    each shard draws its own ε."""
    s = step_seed(seed, step)
    return s if group is None else fold_in(s, dist.get_rank(group))


def all_reduce_mean(tensors, group) -> list:
    """The mean of ``tensors`` over ``group``: one all-reduce of one flat
    bucket, divided by the group's size. Returns new tensors, views of
    the bucket."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def mean_metrics(metrics: dict, group) -> dict:
    """Scalar metrics averaged over ``group`` in one all-reduce."""
    keys = list(metrics)
    vals = all_reduce_mean([torch.stack([metrics[k].float() for k in keys])], group)[0]
    return dict(zip(keys, vals.unbind()))


def _one_step(state: TrainState, xs, cfg: AssocConfig, tc: TrainConfig,
              opt: Optimizer, *, eps=None, group=None, scalars: StepScalars | None = None):
    """One optimizer micro-step on the batch list ``xs``. ε comes from the
    state's stream unless ``eps`` (one tensor per modality) is given.
    Returns (state', metrics) with the metrics as device scalars.

    ``scalars``: the step's values in device memory (its ε seeds, Adam's
    scalars, the annealing weights), read in place of the host's, so the
    step reads nothing from the host (with no ``eps``, no ``group`` and
    accum_steps 1): what ``train_loop_fused`` captures.

    ``group``: the data-parallel process group when ``xs`` are this rank's
    rows of a global batch (the JAX package's ``axis_name``). The rank
    folds into the ε seed, global InfoNCE negatives are gathered over it,
    the gradients are averaged over it in one all-reduce, and so are the
    metrics; ``grad_norm`` is that of the averaged gradient. The step then
    follows the gradient of the global batch's mean loss.

    Spans ``train.step`` and, under it, ``step.forward`` (the objective),
    ``step.backward`` (the gradients and their all-reduce) and
    ``step.optimizer`` (the norm and the update)."""
    if scalars is not None and (eps is not None or group is not None):
        raise ValueError("device step scalars take neither eps nor a group")
    with spans.span("train.step"):
        params = list(state.params.parameters())
        with spans.span("step.forward"):
            if scalars is not None:
                seed = scalars.seeds
            else:
                seed = step_seed_of_rank(state.seed, state.step, group) if eps is None else None
            total, metrics = assoc_mod.assoc_loss_fn(
                state.params, list(xs), cfg, seed=seed,
                eps=eps, compute_dtype=tc.compute_dtype, parity_mode=tc.parity_mode,
                use_pallas=tc.use_pallas, remat=tc.remat, data_group=group,
            )
            total, metrics = apply_objective_weights(
                total, metrics, cfg, tc, state.step,
                weights=None if scalars is None else scalars.objective)
        with spans.span("step.backward"):
            grads = torch.autograd.grad(total, params)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if group is not None:
                grads = all_reduce_mean(grads, group)
                metrics = mean_metrics(metrics, group)
        with spans.span("step.optimizer"):
            metrics["grad_norm"] = global_norm(grads)
            opt.update(grads, state.opt_state, params,
                       scalars=None if scalars is None else scalars.adam)
    return state._replace(step=state.step + 1), metrics


def stacked_steps(one_step, n: int):
    """``step_fn(state, xs, eps=None)`` over ``one_step(state, xs, eps)``:
    with ``n == 1`` one step on [B, ...] batches; with n > 1, n steps on
    [n, B, ...] stacks (``eps`` stacked alike) run back to back, every
    metric with a leading [n] axis. The one ``steps_per_call`` loop of the
    single-device step and of the parallel layouts."""

    def step_fn(state, xs, eps=None):
        if n == 1:
            return one_step(state, list(xs), eps)
        out = []
        for i in range(n):
            state, m = one_step(state, [x[i] for x in xs],
                                None if eps is None else [e[i] for e in eps])
            out.append(m)
        return state, {k: torch.stack([m[k] for m in out]) for k in out[0]}

    return step_fn


def make_train_step(cfg: AssocConfig, tc: TrainConfig):
    """``step_fn(state, xs, eps=None) -> (state', metrics)``.

    With ``steps_per_call == 1`` ``xs`` is a list of per-modality batches
    [B, n_input_k] and the metrics are scalars; with N > 1 it is a list of
    batch stacks [N, B, n_input_k], the N steps run back to back and every
    metric has a leading [N] axis (``stacked_steps``)."""
    opt = make_optimizer(tc)

    def one(state, xs, eps):
        return _one_step(state, xs, cfg, tc, opt, eps=eps)

    return stacked_steps(one, tc.steps_per_call)
