"""Epoch loops around the train step (counterpart of vae_assoc_tpu/train/loop.py).

The data is staged on the device once and every epoch's shuffle is a
gather on the device. ``train_loop`` shuffles with the JAX package's numpy
permutation stream (so both packages see the same batch order) and syncs
with the host once per epoch; ``train_loop_fused`` shuffles on the device,
syncs once at the end and, on CUDA, replays each step from one CUDA graph.
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from vae_assoc_tpu_torch.configs import AssocConfig, TrainConfig
from vae_assoc_tpu_torch.kernels import _launches
from vae_assoc_tpu_torch.kernels import mlp as kmlp
from vae_assoc_tpu_torch.models.networks import cuda_or_raise
from vae_assoc_tpu_torch.ops.sampling import fold_in
from vae_assoc_tpu_torch.train.step import (
    StepScalars,
    TrainState,
    _one_step,
    init_train_state,
    make_optimizer,
    make_train_step,
    objective_width,
    step_scalar_rows,
)
from vae_assoc_tpu_torch.utils import spans

GRAPH = spans.Counters(("captures", "replays", "eager_steps"))
"""The ``train.graph`` counters of ``train_loop_fused``: steps captured in
a CUDA graph, replays of a captured step (the step that a capture ends in
is its first), and steps run eagerly (the first for each key, and every
step where the graph does not engage)."""

_graphs = weakref.WeakKeyDictionary()  # a state's module -> its _StepGraph


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


class _StepGraph:
    """One training step captured in a CUDA graph, for one key: the device,
    the batch's shapes and dtypes, ``cfg``, ``tc`` and the addresses of the
    weights and of the optimizer state.

    The step reads static buffers: ``xs``, each modality's batch, and
    ``slot``, its :class:`StepScalars` row. The first step for the key runs
    eagerly on them (it warms cuBLAS, the allocator and the kernels' host
    tables), the second is captured and then replayed as that step, and
    every later one is a replay. ``row`` holds the captured step's metrics
    in ``keys`` order. ``keep`` holds what the graph reads that it did not
    allocate, so that its memory outlives the graph."""

    def __init__(self, key, cfg: AssocConfig, tc: TrainConfig, dev_data, keep):
        dev = dev_data[0].device
        self.key, self.keep = key, keep
        self.xs = [torch.empty((tc.batch_size,) + tuple(d.shape[1:]), dtype=d.dtype, device=dev)
                   for d in dev_data]
        obj = objective_width(cfg, tc)
        k = len(cfg.modalities)
        self.slot = torch.empty(StepScalars.width(k, obj), dtype=torch.int64, device=dev)
        self.scalars = StepScalars.of_row(self.slot, k, obj)
        self.graph = self.row = self.keys = None
        self.launches = []

    def step(self, state: TrainState, scalar_row, cfg, tc, opt):
        """One step on ``xs`` with the scalars ``scalar_row`` (a row of
        ``step_scalar_rows`` on the device). Returns (state', metrics row)."""
        if self.graph is not None:
            with spans.span("train.step"):
                self.slot.copy_(scalar_row)
                with spans.span("step.replay"):
                    self.graph.replay()
            opt.count_update(state.opt_state)
            for table, counts in self.launches:
                for name, n in counts.items():
                    table.add(name, n, shared=True)
            GRAPH.add("replays")
            return state._replace(step=state.step + 1), self.row
        self.slot.copy_(scalar_row)
        if self.keys is None:
            state, m = _one_step(state, self.xs, cfg, tc, opt, scalars=self.scalars)
            self.keys = list(m)
            GRAPH.add("eager_steps")
            return state, torch.stack([m[k] for k in self.keys])
        tables = (_launches.SERVING, _launches.TRAINING)
        before = [dict(t) for t in tables]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            state, m = _one_step(state, self.xs, cfg, tc, opt, scalars=self.scalars)
            self.row = torch.stack([m[k] for k in self.keys])
        # A replay counts the launches the captured step counted.
        self.launches = [(t, {n: v - b[n] for n, v in t.items() if v != b[n]})
                         for t, b in zip(tables, before)]
        self.keep += tuple(kmlp.device_tables())
        self.graph = graph
        GRAPH.add("captures")
        graph.replay()
        GRAPH.add("replays")
        return state, self.row


def _step_graph(state: TrainState, cfg: AssocConfig, tc: TrainConfig, dev_data):
    """The state's captured step for this call's key (kept across calls,
    weakly by the state's module), or None where the graph does not engage."""
    if dev_data[0].device.type != "cuda" or tc.accum_steps != 1:
        return None
    tensors = tuple(state.params.parameters()) + tuple(
        t for l in state.opt_state.lists() if l is not None for t in l)
    key = (dev_data[0].device, tuple((tuple(d.shape[1:]), d.dtype) for d in dev_data),
           cfg, tc, tuple(t.data_ptr() for t in tensors))
    g = _graphs.get(state.params)
    if g is None or g.key != key:
        g = _graphs[state.params] = _StepGraph(key, cfg, tc, dev_data, tensors)
    return g


def train_loop_fused(cfg: AssocConfig, tc: TrainConfig, data, *, epochs: int = 10,
                     state: TrainState | None = None, shuffle: bool = True,
                     device=None):
    """Device-resident training: every step of every epoch is enqueued with
    no host sync, and the per-epoch metric means come back in one copy at
    the end.

    Each epoch is shuffled on the device by ``torch.randperm`` from a
    generator seeded with (tc.seed ^ 0x5EED, start_step), so a run is
    deterministic in ``tc.seed`` and a resumed run does not replay its
    permutations; each step gathers its rows into the step's batch
    buffers. Steps per epoch are whole ``steps_per_call`` groups. Returns
    (state, history); ``samples_per_sec`` is the whole run's rate,
    repeated in every epoch's entry, and includes the first step's build
    of the kernels unless they were built before.

    On CUDA the step runs from one CUDA graph: the step's per-step values
    (its ε seeds, Adam's scalars, the annealing weights) are computed on
    the host for all of the call's steps, sent over in one copy, and
    written into the graph's scalar slot before each replay. The first
    step for a key (the device, the batch's shapes, ``cfg``, ``tc``, the
    weights' and the optimizer state's addresses) runs eagerly, the next
    is captured; the capture is kept across calls, weakly by
    ``state.params``. The step runs eagerly instead, with the same bits,
    off CUDA and with ``accum_steps > 1`` (MultiSteps' update is host
    control flow). ``GRAPH`` counts the captures, replays and eager steps.

    Spans ``train.call`` (the whole call, each step's gather of its rows
    included), ``train.shuffle`` (each epoch's permutation) and
    ``train.sync`` (the closing host copy of the metric means), with the
    steps' ``train.step`` spans between them: a replayed step's holds the
    copy of its scalars and ``step.replay``."""
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
        graph = _step_graph(state, cfg, tc, dev_data)
        if graph is None:
            xs = [torch.empty((bs,) + tuple(d.shape[1:]), dtype=d.dtype, device=dev)
                  for d in dev_data]
        else:
            xs = graph.xs
            rows = torch.from_numpy(step_scalar_rows(state, cfg, tc, epochs * steps))
            rows = rows.pin_memory().to(dev, non_blocking=True)

        t0 = time.perf_counter()
        means, keys, buf = [], None, None
        for e in range(epochs):
            with spans.span("train.shuffle"):
                if shuffle:
                    perm = torch.randperm(n, generator=gen, device=dev)[:used]
                else:
                    perm = torch.arange(used, device=dev)
            for s in range(steps):
                for a, x in zip(dev_data, xs):
                    torch.index_select(a, 0, perm[s * bs:(s + 1) * bs], out=x)
                if graph is None:
                    state, m = _one_step(state, xs, cfg, tc, opt)
                    GRAPH.add("eager_steps")
                    keys = list(m)
                    row = torch.stack([m[k] for k in keys])
                else:
                    state, row = graph.step(state, rows[e * steps + s], cfg, tc, opt)
                    keys = graph.keys
                if buf is None:
                    buf = torch.empty((steps, len(keys)), dtype=row.dtype, device=dev)
                buf[s].copy_(row)
            means.append(buf.mean(0))
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
