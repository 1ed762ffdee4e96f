"""Epoch loops around the train step (counterpart of vae_assoc_tpu/train/loop.py).

The data is staged on the device once and every epoch's shuffle is a
gather on the device. ``train_loop`` shuffles with the JAX package's numpy
permutation stream (so both packages see the same batch order) and syncs
with the host once per epoch; ``train_loop_fused`` shuffles on the device
and syncs once at the end. CUDA-graph capture of the step is later work.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vae_assoc_tpu_torch.configs import AssocConfig, TrainConfig
from vae_assoc_tpu_torch.models.networks import cuda_or_raise
from vae_assoc_tpu_torch.ops.sampling import fold_in
from vae_assoc_tpu_torch.train.step import (
    TrainState,
    _one_step,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from vae_assoc_tpu_torch.utils import spans


def _stage(data, device) -> list:
    n = data[0].shape[0]
    for k, d in enumerate(data):
        if d.shape[0] != n:
            raise ValueError(f"modality {k} has {d.shape[0]} rows, expected {n}")
    return [torch.as_tensor(d, dtype=torch.float32, device=device) for d in data]


def _device(state, data, device, what):
    """The device to train on: ``device``, else the state's, else that of
    tensor data; host arrays with nothing else named train on the card."""
    if device is None and state is not None:
        device = next(state.params.parameters()).device
    elif device is None and isinstance(data[0], torch.Tensor):
        device = data[0].device
    return cuda_or_raise("cuda" if device is None else device, what)


def train_loop(cfg: AssocConfig, tc: TrainConfig, data, *, epochs: int = 10,
               state: TrainState | None = None, display_step: int = 1,
               on_metrics=None, shuffle: bool = True, device=None, refresh_data=None):
    """Train for ``epochs`` over K row-paired arrays [N, n_input_k].

    Each epoch's permutation is ``np.random.default_rng([tc.seed,
    start_step]).permutation(N)`` drawn in sequence, the JAX package's
    stream, gathered on the device into ``steps_per_call`` stacks; the
    remainder past whole batches is dropped. ``on_metrics(epoch, metrics)``
    runs every ``display_step`` epochs. ``refresh_data(epoch)``, called at
    each epoch's start with the loop's own epoch index, returns the K
    arrays to train that epoch on, of the original shapes (the per-epoch
    augmentation hook: ``PairedDataset.features(augment=, generator=)``).
    Returns (state, history of per-epoch mean metrics with
    ``samples_per_sec``)."""
    dev = _device(state, data, device, "train_loop")
    dev_data = _stage(data, dev)
    if state is None:
        state = init_train_state(cfg, tc, device=dev)
    return epoch_loop(tc, dev_data, make_train_step(cfg, tc), state, epochs=epochs,
                      display_step=display_step, on_metrics=on_metrics, shuffle=shuffle,
                      refresh_data=refresh_data)


def epoch_loop(tc: TrainConfig, dev_data: list, step_fn, state: TrainState, *,
               epochs: int, display_step: int = 1, on_metrics=None, shuffle: bool = True,
               refresh_data=None, rows: slice = slice(None), n_chips=None):
    """The epoch body of ``train_loop`` and of the parallel layouts' loops:
    ``step_fn(state, xs)`` over the staged arrays ``dev_data``, as
    ``train_loop`` says. ``rows``: the rows of every global batch this
    process takes (its shard; all of them by default). ``n_chips``: the
    devices the global batch spans, which adds
    ``samples_per_sec_per_chip`` to the history.

    Spans ``train.call`` (the whole call), ``train.shuffle`` (each epoch's
    permutation and gathers) and ``train.sync`` (each epoch's host copy of
    the metrics), with ``step_fn``'s ``train.step`` spans between them."""
    with spans.span("train.call"):
        dev = dev_data[0].device
        n = dev_data[0].shape[0]
        bs, spc = tc.batch_size, tc.steps_per_call
        nb = n // bs
        if nb == 0:
            raise ValueError(f"batch_size {bs} > dataset size {n}")
        n_calls = nb // spc
        if n_calls == 0:
            raise ValueError(f"steps_per_call {spc} > batches/epoch {nb}")
        shuffle_rng = np.random.default_rng([tc.seed, int(state.step)])
        used = n_calls * spc * bs

        history = []
        for epoch in range(epochs):
            if refresh_data is not None:
                fresh = list(refresh_data(epoch))
                if len(fresh) != len(dev_data) or any(
                        tuple(f.shape) != tuple(d.shape) for f, d in zip(fresh, dev_data)):
                    raise ValueError(
                        "refresh_data must return arrays with the original shapes "
                        f"{[tuple(d.shape) for d in dev_data]}, got "
                        f"{[tuple(f.shape) for f in fresh]}"
                    )
                dev_data = _stage(fresh, dev)
            with spans.span("train.shuffle"):
                perm = shuffle_rng.permutation(n) if shuffle else np.arange(n)
                local = np.ascontiguousarray(perm[:used].reshape(n_calls, spc, bs)[:, :, rows])
                idx = torch.as_tensor(local, dtype=torch.int64, device=dev)
                stacks = [a[idx] for a in dev_data]  # [n_calls, spc, rows, n_input]
            t0 = time.perf_counter()
            acc = []
            for c in range(n_calls):
                xs = [s[c] if spc > 1 else s[c, 0] for s in stacks]
                state, metrics = step_fn(state, xs)
                acc.append(metrics)
            # One host sync per epoch, after every call is enqueued.
            keys = list(acc[0])
            with spans.span("train.sync"):
                host = torch.stack([torch.stack([m[k].reshape(-1) for k in keys])
                                    for m in acc]).cpu().numpy()
            dt = time.perf_counter() - t0
            mean_metrics = {k: float(np.mean([np.mean(h[i]) for h in host]))
                            for i, k in enumerate(keys)}
            mean_metrics["samples_per_sec"] = used / dt
            if n_chips is not None:
                mean_metrics["samples_per_sec_per_chip"] = used / dt / n_chips
            history.append(mean_metrics)
            if on_metrics is not None and epoch % display_step == 0:
                on_metrics(epoch, mean_metrics)
        return state, history


def train_loop_fused(cfg: AssocConfig, tc: TrainConfig, data, *, epochs: int = 10,
                     state: TrainState | None = None, shuffle: bool = True,
                     device=None):
    """Device-resident training: every step of every epoch is enqueued with
    no host sync, and the per-epoch metric means come back in one copy at
    the end.

    Each epoch is shuffled on the device by ``torch.randperm`` from a
    generator seeded with (tc.seed ^ 0x5EED, start_step), so a run is
    deterministic in ``tc.seed`` and a resumed run does not replay its
    permutations. Steps per epoch are whole ``steps_per_call`` groups.
    Returns (state, history); ``samples_per_sec`` is the whole run's rate,
    repeated in every epoch's entry, and includes the first step's build
    of the kernels unless they were built before.

    Spans ``train.call`` (the whole call), ``train.shuffle`` (each epoch's
    permutation and gathers) and ``train.sync`` (the closing host copy of
    the metric means), with the steps' ``train.step`` spans between them."""
    with spans.span("train.call"):
        dev = _device(state, data, device, "train_loop_fused")
        dev_data = _stage(data, dev)
        n = dev_data[0].shape[0]
        bs, spc = tc.batch_size, tc.steps_per_call
        steps = (n // bs // spc) * spc
        if steps == 0:
            raise ValueError(f"dataset of {n} rows < batch_size*steps_per_call = {bs * spc}")
        used = steps * bs
        if state is None:
            state = init_train_state(cfg, tc, device=dev)
        opt = make_optimizer(tc)
        gen = torch.Generator(device=dev)
        gen.manual_seed(fold_in(tc.seed ^ 0x5EED, state.step) >> 1)

        t0 = time.perf_counter()
        means, keys = [], None
        for _ in range(epochs):
            with spans.span("train.shuffle"):
                if shuffle:
                    perm = torch.randperm(n, generator=gen, device=dev)[:used]
                else:
                    perm = torch.arange(used, device=dev)
                stacks = [a[perm].reshape(steps, bs, a.shape[-1]) for a in dev_data]
            per_step = []
            for s in range(steps):
                state, m = _one_step(state, [x[s] for x in stacks], cfg, tc, opt)
                per_step.append(m)
            keys = list(per_step[0])
            means.append(torch.stack([torch.stack([m[k] for m in per_step]).mean() for k in keys]))
        with spans.span("train.sync"):
            em = torch.stack(means).cpu().numpy()
        dt = time.perf_counter() - t0
        sps = epochs * used / dt
        history = []
        for e in range(epochs):
            h = {k: float(em[e, i]) for i, k in enumerate(keys)}
            h["samples_per_sec"] = sps
            history.append(h)
        return state, history
