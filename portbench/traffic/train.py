"""Training traffic: ``train_loop_fused`` over a dataset on the card, one epoch a call.

Mix parameters: ``pairs`` (rows of the dataset) and ``train`` (the
``TrainConfig`` fields the cell fixes: batch size, compute dtype, kernel
path, ``steps_per_call``, Adam's settings); the run's seed is the
config's ``seed``.

Set-up makes the data and the weights from the seed on the card, loads the
weights into the program's ``AssocVAE``, and builds the one training state
that the window then drives. Through the window's own call it first takes
three one-step epochs on three distinct blocks of ``batch_size`` rows: the
loss of each, the first gradient (Adam's first moment after one update
over 1 − b1) and the change of every weight after the third are kept for
the check. One epoch over the whole dataset then warms the window's
shapes. The window calls ``train_loop_fused(..., epochs=1, state=state)``
until ``--seconds`` have passed; each call ends in its own host sync.
With ``--trace 1`` a traced window of up to ``TRACE_S`` seconds follows,
driven the same way: the per-layer metrics that read the device read it,
and those that read a rate read the measured window.

After the window, with the peak memory read and the program's state freed,
the plain reference takes the same three steps from the same weights on
the same rows, in the order the program's permutation gives, with the same
ε, and ``compare.train_readings`` sets the program's numbers beside it.
The reference's products take their operands in the precision the cell
states (``REFERENCE``: bf16 for a bfloat16 cell), and every other
operation, the sums of the products and Adam run in float32.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import compare, inputs, roofline, trace
from portbench.reference import model as ref

CHECK_STEPS = 3
REFERENCE = {"float32": "fp32", "bfloat16": "bf16"}  # the products' precision, by compute dtype
TRACE_S = 5.0  # the longest traced window


def build(ctx):
    """(cfg, tc, data, w0, state) of the cell, from the seed."""
    from vae_assoc_tpu_torch.configs import config_from_dict
    from vae_assoc_tpu_torch.models.assoc import AssocVAE
    from vae_assoc_tpu_torch.train import init_train_state

    cfg, tc = config_from_dict({**ctx.model, "train": {**ctx.mix["train"], "seed": ctx.seed}})
    dev = torch.device(ctx.device)
    data = inputs.make_pairs(ctx.model, int(ctx.mix["pairs"]), ctx.seed, dev)
    w0 = inputs.make_weights(ctx.model, ctx.seed, dev, ctx.conv_channels)
    model = AssocVAE(cfg, device=dev)
    model.load_state_dict(w0)
    return cfg, tc, data, w0, init_train_state(cfg, tc, device=dev, params=model)


def program_steps(cfg, tc, state, blocks, call=None):
    """Drive ``state`` through one one-step epoch per block of rows, by the
    window's call: ``call(state, rows) -> (state, history)``, by default
    ``train_loop_fused(cfg, tc, rows, epochs=1, state=state)``. Returns
    (state, (losses, first gradient, change))."""
    if call is None:
        from vae_assoc_tpu_torch.train import train_loop_fused

        def call(state, xs):
            return train_loop_fused(cfg, tc, xs, epochs=1, state=state)

    params = dict(state.params.named_parameters())
    w0 = {n: p.detach().clone() for n, p in params.items()}
    losses, grad1 = [], None
    for xs in blocks:
        state, hist = call(state, xs)
        losses.append(hist[0]["total"])
        if grad1 is None:
            grad1 = {n: m.detach().clone() / (1.0 - tc.adam_b1)
                     for n, m in zip(params, state.opt_state.adam.mu)}
    change = {n: p.detach() - w0[n] for n, p in params.items()}
    return state, (losses, grad1, change)


def reference_steps(ctx, w0, blocks, precision=None, half_batch=False):
    """The reference's three steps on the rows the program took, its
    products in ``precision`` (by default the cell's, ``REFERENCE``)."""
    precision = precision or REFERENCE[ctx.mix["train"]["compute_dtype"]]
    dev = blocks[0][0].device
    batches = []
    for k, xs in enumerate(blocks):
        perm = ref.epoch_perm(ctx.seed, k, xs[0].shape[0], dev)
        batches.append([x[perm] for x in xs])
    return ref.train_steps(w0, ctx.model, ctx.mix["train"], batches, ctx.seed,
                           precision=precision, half_batch=half_batch)


def check_blocks(data, bs):
    return [[d[k * bs:(k + 1) * bs].clone() for d in data] for k in range(CHECK_STEPS)]


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
        # A traced window of its own after the measured one: the profiler's
        # own cost (CUPTI's, on every launch) stays out of the measured rate.
        prof.start()
        t2 = time.perf_counter()
        traced = 0
        while time.perf_counter() - t2 < min(ctx.seconds, TRACE_S):
            state, _ = train_loop_fused(cfg, tc, data, epochs=1, state=state)
            traced += 1
        obs["trace_window_s"] = time.perf_counter() - t2
        prof.stop()
        obs["trace"] = trace.summarize(prof, obs["trace_window_s"])
        obs["trace_steps"] = traced * steps
        obs["step_flops"] = roofline.step_flops(ctx.model, bs, ctx.conv_channels)
        obs["least_step_s"] = roofline.least_step_s(ctx.model, bs, tc.compute_dtype,
                                                    ctx.conv_channels)
        obs["peak_flops_per_s"] = roofline.PEAK_FLOPS_PER_S[tc.compute_dtype]
    if cuda:
        obs["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        obs["device_name"] = torch.cuda.get_device_name()
    del state, data, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    obs["readings"] = compare.train_readings(prog, reference_steps(ctx, w0, blocks))
    return obs
