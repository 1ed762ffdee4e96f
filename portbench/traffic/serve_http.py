"""Served traffic: ``serve_http.ModelServer`` over ``Predictor``, driven over HTTP by ``loadgen.py``.

Mix parameters: ``rate_per_s`` (the offered load, fixed in the mix),
``max_batch`` and ``max_wait_ms`` (the server's coalescing), ``use_pallas``
and ``compute_dtype`` (the predictor's), ``src`` and ``dst`` (the route's
modalities), ``pool`` (distinct request images), ``sample`` (answers kept
for the check).

Set-up makes the weights from the seed on the card, loads them into the
program's ``AssocVAE``, builds the ``Predictor`` and a ``ModelServer``
(which warms every bucket it can dispatch) on a free localhost port, and
starts the load generator as a child process with a pipe for its output.
The window runs from the generator's ``start`` to its last answer. After
it the server is closed, the peak memory read and the program's state
freed, and the plain reference answers the sampled requests from the same
weights and the same image bytes; ``compare.answer_gap`` sets the served
answers beside it.

The harness times each call of ``Predictor.cross_generate`` (bucketing,
copies, kernels) by the host clock, for ``dispatch_ms.serve``, through a
wrapper it sets on the predictor it built; the ``MicroBatcher`` calls
that instance.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import compare, inputs, trace
from portbench.reference import model as ref
from portbench.traffic import loadgen

LOADGEN = Path(loadgen.__file__).resolve()


def _timed(fn, times):
    def call(*a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        times.append((t, time.perf_counter() - t))
        return out

    return call


def start_server(ctx):
    """(server, port, w0, dispatch times) of the cell, from the seed."""
    from vae_assoc_tpu_torch.configs import config_from_dict
    from vae_assoc_tpu_torch.models.assoc import AssocVAE
    from vae_assoc_tpu_torch.serve import Predictor
    from vae_assoc_tpu_torch.serve_http import ModelServer

    mix = ctx.mix
    cfg, _ = config_from_dict(ctx.model)
    dev = torch.device(ctx.device)
    w0 = inputs.make_weights(ctx.model, ctx.seed, dev, ctx.conv_channels)
    model = AssocVAE(cfg, device=dev)
    model.load_state_dict(w0)
    pred = Predictor(model, cfg, device=dev, compute_dtype=mix["compute_dtype"],
                     use_pallas=mix["use_pallas"])
    times = []
    pred.cross_generate = _timed(pred.cross_generate, times)
    server = ModelServer(pred, max_batch=int(mix["max_batch"]),
                         max_wait_ms=float(mix["max_wait_ms"]))
    return server, server.start("127.0.0.1", 0), w0, times


def generate(port, seed, rate, seconds, mix, before=None):
    """Run the load generator against ``port``; returns its result object
    with ``t0``, the host clock when it began to send. ``before()`` runs
    once the generator has warmed up, just before it is let go."""
    cmd = [sys.executable, str(LOADGEN), "--port", str(port), "--seed", str(seed),
           "--rate", repr(float(rate)), "--seconds", repr(float(seconds)),
           "--pool", str(mix["pool"]), "--sample", str(mix["sample"]),
           "--src", mix["src"], "--dst", mix["dst"]]
    with subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True) as child:
        for want in ("ready", "start"):
            line = child.stdout.readline()
            if line.strip() != want:
                child.kill()
                raise RuntimeError(f"load generator said {line!r}, not {want!r}")
            if want == "ready":
                if before is not None:
                    before()
                child.stdin.write("go\n")
                child.stdin.flush()
            else:
                t0 = time.perf_counter()
        result = child.stdout.read()
        if child.wait() != 0:
            raise RuntimeError(f"load generator exited {child.returncode}")
    return dict(json.loads(result.strip().splitlines()[-1]), t0=t0)


def reference_answers(ctx, w0, sample, precision="fp32") -> torch.Tensor:
    """The reference's answers to the sampled requests, from the same
    weights and the same image bytes."""
    images = loadgen.pool_images(ctx.seed, int(ctx.mix["pool"]))[sample["pool"]]
    names = [m["name"] for m in ctx.model["modalities"]]
    x = torch.from_numpy(images.astype(np.float32)).to(next(iter(w0.values())).device)
    with ref.exact_fp32(), torch.no_grad():
        return ref.cross_generate(w0, ctx.model, x, names.index(ctx.mix["src"]),
                                  names.index(ctx.mix["dst"]), precision)


def reference_gap(ctx, w0, sample) -> float:
    """The widest gap of the sampled answers against the reference's."""
    if not sample["request"]:
        return float("nan")
    want = reference_answers(ctx, w0, sample)
    return compare.answer_gap(torch.tensor(sample["outputs"], device=want.device), want)


def run(ctx) -> dict:
    server, port, w0, times = start_server(ctx)
    cuda = ctx.device == "cuda"
    prof = trace.profiler(ctx.trace)
    try:
        result = generate(port, ctx.seed, ctx.mix["rate_per_s"], ctx.seconds, ctx.mix,
                          before=None if prof is None else prof.start)
        t1 = time.perf_counter()
        if prof is not None:
            prof.stop()
    finally:
        server.close()
    t0 = result["t0"]
    lat = result["latencies_s"]
    failed = sum(x is None for x in lat)
    obs = {"setup_s": t0 - ctx.t_start, "window_s": t1 - t0, "latencies_s": lat,
           "attempted": len(lat), "failed": failed, "complete": failed == 0,
           "completed": result["completed"], "dispatches": result["dispatches"],
           "dispatch_s": [dt for t, dt in times if t0 <= t <= t1], "late_s": result["late_s"]}
    print(f"loadgen: {len(lat)} requests at {ctx.mix['rate_per_s']}/s, sends late by "
          f"{result['late_s']}, {failed} failed", file=sys.stderr)
    if cuda:
        obs["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        obs["device_name"] = torch.cuda.get_device_name()
    if ctx.trace:
        obs["trace"] = trace.summarize(prof, t1 - t0)
    del server, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    obs["readings"] = {"answer": reference_gap(ctx, w0, result["sample"])}
    return obs
