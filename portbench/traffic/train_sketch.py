"""Sketch-RNN training traffic: ``train_loop_fused`` over sketches and bitmaps, one epoch a call.

Mix parameters: ``pairs`` (rows of the dataset), ``min_length`` (the
shortest sketch), ``pen_lift`` (a point's chance of lifting the pen) and
``train`` (the ``TrainConfig`` fields the cell fixes); the run's seed is the
config's ``seed``. The driver mirrors traffic/train.py: the same ``build``,
``check_blocks``, ``program_steps`` and ``reference_steps``, the same three
one-step epochs through the window's own call, the same warm-up and
windows, and ``compare.train_readings`` against the plain reference
(reference/sketch_rnn.py) after the window.

Inputs from the seed (``inputs.generator``), made on the card: each sketch's
length L uniform on [min_length, max_seq_len]; its offsets N(0, 1) (Sketch-RNN
normalises offsets to unit deviation); each point lifts the pen (p2) with
chance ``pen_lift``, else draws on (p1); points past L are (0, 0, 0, 0, 1);
every row starts with S_0 = (0, 0, 1, 0, 0). Bitmaps are uniform on [0, 1).

With ``--trace 1`` the driver also sums the profile's device time by kernel
name itself (``trace.summarize`` keeps only ten operations): the ``lstm_fwd``
and ``lstm_bwd`` kernels and ``mixture_loss``; it reads the launch counters
of the three across the traced window, and puts the step's FLOPs and the
least time of the step, the recurrences and the mixture loss in the
observations (reference/sketch_rnn.py counts them).
"""

from __future__ import annotations

import gc
import time

import torch
from torch.autograd import DeviceType

from portbench import compare, inputs, roofline, trace
from portbench.reference import model as ref
from portbench.reference import sketch_rnn as sk
from portbench.traffic.train import REFERENCE, TRACE_S, check_blocks, program_steps  # noqa: F401

SKETCH_KERNELS = ("lstm_fwd", "lstm_bwd", "mixture_loss")


def make_pairs(model: dict, mix: dict, n: int, seed: int, device) -> list:
    """[bitmaps [n, 784], sketches [n, max_seq_len + 1, 5]] from the seed."""
    g = inputs.generator(seed, inputs.DATA, device)
    img = torch.rand(n, int(model["modalities"][0]["arch"]["n_input"]), generator=g, device=device)
    steps = sk._sketch(model)[1]["arch"]["max_seq_len"]
    length = torch.randint(int(mix["min_length"]), steps + 1, (n, 1), generator=g, device=device)
    offsets = torch.randn(n, steps, 2, generator=g, device=device)
    lift = (torch.rand(n, steps, 1, generator=g, device=device) < float(mix["pen_lift"])).float()
    pts = torch.cat([offsets, 1.0 - lift, lift, torch.zeros_like(lift)], dim=2)
    pad = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0], device=device)
    pts = torch.where((torch.arange(steps, device=device) >= length)[..., None], pad, pts)
    start = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0], device=device).expand(n, 1, 5)
    return [img, torch.cat([start, pts], dim=1)]


def make_weights(model: dict, seed: int, device) -> dict:
    """Glorot-uniform weights and zero biases by the program's parameter names."""
    return ref.init_params(sk.param_spec(model), inputs.generator(seed, inputs.WEIGHTS, device))


def build(ctx):
    """(cfg, tc, data, w0, state) of the cell, from the seed."""
    from vae_assoc_tpu_torch.configs import config_from_dict
    from vae_assoc_tpu_torch.models.assoc import AssocVAE
    from vae_assoc_tpu_torch.train import init_train_state

    cfg, tc = config_from_dict({**ctx.model, "train": {**ctx.mix["train"], "seed": ctx.seed}})
    dev = torch.device(ctx.device)
    data = make_pairs(ctx.model, ctx.mix, int(ctx.mix["pairs"]), ctx.seed, dev)
    w0 = make_weights(ctx.model, ctx.seed, dev)
    model = AssocVAE(cfg, device=dev)
    model.load_state_dict(w0)
    return cfg, tc, data, w0, init_train_state(cfg, tc, device=dev, params=model)


def reference_steps(ctx, w0, blocks, precision=None, half_batch=False):
    """The reference's three steps on the rows the program took, its
    products in ``precision`` (by default the cell's, ``REFERENCE``)."""
    precision = precision or REFERENCE[ctx.mix["train"]["compute_dtype"]]
    dev = blocks[0][0].device
    batches = []
    for k, xs in enumerate(blocks):
        perm = ref.epoch_perm(ctx.seed, k, xs[0].shape[0], dev)
        batches.append([x[perm] for x in xs])
    return sk.train_steps(w0, ctx.model, ctx.mix["train"], batches, ctx.seed,
                          precision=precision, half_batch=half_batch)


def kernel_seconds(prof) -> dict:
    """Device seconds of each of ``SKETCH_KERNELS``, summed over every
    kernel whose name holds it."""
    out = dict.fromkeys(SKETCH_KERNELS, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in SKETCH_KERNELS:
                if k in e.name:
                    out[k] += (e.time_range.end - e.time_range.start) * 1e-6
    return out


def _launches():
    """The three kernels' launch counts, or None where the program has no
    such counter."""
    from vae_assoc_tpu_torch.kernels import _launches as launches

    snap = launches.snapshot()
    return sum(snap[k] for k in SKETCH_KERNELS) if all(k in snap for k in SKETCH_KERNELS) else None


def run(ctx) -> dict:
    from vae_assoc_tpu_torch.train import train_loop_fused

    cfg, tc, data, w0, state = build(ctx)
    bs = tc.batch_size
    blocks = check_blocks(data, bs)
    state, prog = program_steps(cfg, tc, state, blocks)
    state, _ = train_loop_fused(cfg, tc, data, epochs=1, state=state)
    cuda = ctx.device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    n = data[0].shape[0]
    steps = (n // bs // tc.steps_per_call) * tc.steps_per_call
    t0 = time.perf_counter()
    calls = 0
    while True:
        state, _ = train_loop_fused(cfg, tc, data, epochs=1, state=state)
        calls += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    obs = {"setup_s": t0 - ctx.t_start, "window_s": window_s, "samples": calls * steps * bs,
           "steps": calls * steps, "attempted": calls * steps, "failed": 0, "complete": True}
    prof = trace.profiler(ctx.trace)
    if prof is not None:
        before = _launches()
        prof.start()
        t2 = time.perf_counter()
        traced = 0
        while time.perf_counter() - t2 < min(ctx.seconds, TRACE_S):
            state, _ = train_loop_fused(cfg, tc, data, epochs=1, state=state)
            traced += 1
        obs["trace_window_s"] = time.perf_counter() - t2
        prof.stop()
        after = _launches()
        obs["trace"] = trace.summarize(prof, obs["trace_window_s"])
        obs["trace_steps"] = traced * steps
        if before is not None:
            obs["sketch_launches"] = after - before
        obs["kernel_s"] = kernel_seconds(prof)
        flops = sk.step_flops(ctx.model, bs)
        peak = roofline.PEAK_FLOPS_PER_S[tc.compute_dtype]
        obs["step_flops"] = flops
        obs["peak_flops_per_s"] = peak
        n_params = sum(w.numel() for w in w0.values())
        step_bytes = 4 * sum(x[:bs].numel() for x in data) + 4 * 6 * n_params
        obs["least_step_s"] = max(flops / peak, step_bytes / roofline.HBM_BYTES_PER_S)
        obs["lstm_least_step_s"] = max(sk.lstm_flops(ctx.model, bs) / peak,
                                       sk.lstm_bytes(ctx.model, bs) / roofline.HBM_BYTES_PER_S)
        obs["mixture_least_step_s"] = sk.mixture_bytes(ctx.model, bs) / roofline.HBM_BYTES_PER_S
    if cuda:
        obs["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        obs["device_name"] = torch.cuda.get_device_name()
    del state, data, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    obs["readings"] = compare.train_readings(prog, reference_steps(ctx, w0, blocks))
    return obs
