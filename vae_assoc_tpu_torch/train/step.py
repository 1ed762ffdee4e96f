"""The train step (counterpart of vae_assoc_tpu/train/step.py).

One step computes the joint objective, its gradients with respect to the
weights, and the optimizer update, all enqueued on the params' device with
no host synchronisation: the step counter, the ε seed and Adam's bias
corrections are host integers and floats, and everything else stays on the
device. The weights and the optimizer state are updated in place (the JAX
package donates its buffers to the same end).

``make_optimizer`` is the one optimizer source and follows optax's chain of
vae_assoc_tpu/train/step.py::make_optimizer operation for operation —
[MultiSteps(accum_steps) ∘] [clip_by_global_norm ∘] Adam (TF defaults) ∘
learning rate (constant, or cosine, after a linear warmup) [∘ EMA] — so
both packages agree to fp32 rounding from the same gradients.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from vae_assoc_tpu_torch.configs import AssocConfig, TrainConfig
from vae_assoc_tpu_torch.models import assoc as assoc_mod
from vae_assoc_tpu_torch.models.networks import cuda_or_raise
from vae_assoc_tpu_torch.ops.sampling import fold_in


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


class TrainState(NamedTuple):
    step: int  # micro-steps taken
    params: assoc_mod.AssocVAE
    opt_state: OptState
    seed: int  # the ε stream's seed (tc.seed)


def lr_at(tc: TrainConfig, count: int) -> np.float32:
    """The learning rate of the ``count``-th optimizer update, in fp32 as
    optax's schedules compute it (linear warmup joined to a constant or a
    cosine decay)."""
    f32 = np.float32
    if tc.lr_schedule not in ("constant", "cosine"):
        raise ValueError(
            f"unknown lr_schedule {tc.lr_schedule!r}; expected 'constant' or 'cosine'"
        )
    if tc.lr_schedule == "cosine" and tc.decay_steps <= 0:
        raise ValueError(
            "lr_schedule='cosine' needs decay_steps > 0 (the decay horizon in "
            f"optimizer updates), got {tc.decay_steps}"
        )

    def main(c):
        if tc.lr_schedule == "constant":
            return f32(tc.learning_rate)
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


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) over a list of tensors, on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer:
    """Adam with optional clipping, schedule, accumulation and EMA, as
    optax's chain in the JAX package's make_optimizer. ``update`` applies
    the step to the weights in place and advances the state in place."""

    def __init__(self, tc: TrainConfig):
        if tc.ema_decay > 0 and not 0.0 < tc.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {tc.ema_decay}")
        if tc.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
        lr_at(tc, 0)  # validates the schedule
        self.tc = tc

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
    def update(self, grads, state: OptState, params) -> None:
        grads, params = list(grads), list(params)
        k = self.tc.accum_steps
        if k == 1:
            self._inner(grads, state, params)
            return
        # MultiSteps: a running mean of k micro-batch grads (Welford), one
        # inner update when the k-th arrives; the weights hold still between.
        diff = torch._foreach_sub(grads, state.acc)
        torch._foreach_div_(diff, float(state.mini_step + 1))
        torch._foreach_add_(state.acc, diff)
        if state.mini_step == k - 1:
            self._inner(state.acc, state, params)
            torch._foreach_zero_(state.acc)
        state.mini_step = (state.mini_step + 1) % k

    def _inner(self, grads, state: OptState, params) -> None:
        tc = self.tc
        if tc.grad_clip_norm > 0:
            norm = global_norm(grads)
            keep = norm < tc.grad_clip_norm
            scaled = torch._foreach_div(grads, norm)
            torch._foreach_mul_(scaled, tc.grad_clip_norm)
            grads = [torch.where(keep, g, s) for g, s in zip(grads, scaled)]
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
        lr = lr_at(tc, a.count)
        a.count += 1
        bc1 = np.float32(1) - np.float32(b1) ** np.float32(a.count)
        bc2 = np.float32(1) - np.float32(b2) ** np.float32(a.count)
        # u = -lr · m̂ / (√v̂ + eps), m̂ = mu / bc1, v̂ = nu / bc2
        den = torch._foreach_div(a.nu, float(bc2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, tc.adam_eps)
        upd = torch._foreach_div(a.mu, float(bc1))
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, float(-lr))
        if state.ema is not None:
            # EMA of the post-update weights, last in the chain.
            new_p = torch._foreach_add(params, upd)
            torch._foreach_mul_(state.ema, tc.ema_decay)
            torch._foreach_mul_(new_p, 1.0 - tc.ema_decay)
            torch._foreach_add_(state.ema, new_p)
            state.ema_count += 1
        torch._foreach_add_(params, upd)


def make_optimizer(tc: TrainConfig) -> Optimizer:
    """The one optimizer source (see module docstring)."""
    return Optimizer(tc)


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


def _total_with_lambda(metrics: dict, cfg: AssocConfig, lam, kl_w):
    """Σ_k (recon_k + kl_w·kl_k) + lam·assoc from the logged terms; the
    gradient is exact, as the total is linear in them."""
    total = torch.zeros((), dtype=torch.float32, device=metrics["total"].device)
    for m in cfg.modalities:
        total = total + metrics[f"recon_{m.name}"] + float(kl_w) * metrics[f"kl_{m.name}"]
    return total + float(np.float32(lam)) * metrics["assoc"]


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


def apply_objective_weights(total, metrics, cfg: AssocConfig, tc: TrainConfig,
                            step: int):
    """Rebuild (total, metrics) with the β-VAE and annealing knobs' runtime
    weights. Returns the inputs untouched when none is active."""
    w = objective_weights(tc, step)
    if w is None:
        return total, metrics
    kl_w, scale = w
    total = _total_with_lambda(metrics, cfg, scale * np.float32(cfg.assoc_lambda), kl_w)
    dev = total.device
    return total, {**metrics, "total": total,
                   "kl_beta_eff": torch.tensor(float(kl_w), device=dev),
                   "assoc_scale_eff": torch.tensor(float(scale), device=dev)}


def step_seed(seed: int, step: int) -> int:
    """The ε seed of micro-step ``step``; each modality folds in its index
    (models/assoc.modality_seeds)."""
    return fold_in(seed, step)


def _one_step(state: TrainState, xs, cfg: AssocConfig, tc: TrainConfig,
              opt: Optimizer, *, eps=None):
    """One optimizer micro-step on the batch list ``xs``. ε comes from the
    state's stream unless ``eps`` (one tensor per modality) is given.
    Returns (state', metrics) with the metrics as device scalars."""
    params = list(state.params.parameters())
    total, metrics = assoc_mod.assoc_loss_fn(
        state.params, list(xs), cfg,
        seed=step_seed(state.seed, state.step) if eps is None else None, eps=eps,
        compute_dtype=tc.compute_dtype, parity_mode=tc.parity_mode,
        use_pallas=tc.use_pallas, remat=tc.remat,
    )
    total, metrics = apply_objective_weights(total, metrics, cfg, tc, state.step)
    grads = torch.autograd.grad(total, params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = global_norm(grads)
    opt.update(grads, state.opt_state, params)
    return state._replace(step=state.step + 1), metrics


def make_train_step(cfg: AssocConfig, tc: TrainConfig):
    """``step_fn(state, xs) -> (state', metrics)``.

    With ``steps_per_call == 1`` ``xs`` is a list of per-modality batches
    [B, n_input_k] and the metrics are scalars; with N > 1 it is a list of
    batch stacks [N, B, n_input_k], the N steps run back to back and every
    metric has a leading [N] axis."""
    opt = make_optimizer(tc)
    n = tc.steps_per_call

    def step_fn(state: TrainState, xs):
        if n == 1:
            return _one_step(state, xs, cfg, tc, opt)
        out = []
        for i in range(n):
            state, m = _one_step(state, [x[i] for x in xs], cfg, tc, opt)
            out.append(m)
        return state, {k: torch.stack([m[k] for m in out]) for k in out[0]}

    return step_fn
