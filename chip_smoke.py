#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vae_assoc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. torch and CUDA versions, the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from vae_assoc_tpu_torch/kernels/csrc.
3. Each kernel against its plain torch twin on the card: the config-3
   image and trajectory towers, a depth-3 tower and a conditional tower
   (n_cond=10), batches 1 to 4096, fp32 (rtol = atol = 1e-4: another
   summation order) and bf16 (rtol = atol = 2e-2: bf16 re-rounding of the
   activations between layers may flip); each gives identical bits on a
   second call.
4. Serving, the port's main path: baseline config 3 at full width with
   random weights from seed 0, a Predictor on the fused kernels behind
   ModelServer, every HTTP route, 16 concurrent requests; outputs checked
   for shape, finiteness and range, and against the same model served on
   the plain path. The kernels' launch counts are reset just before the
   requests and the MLP kernels' must be positive after them.
4b. Serving config 4 with encoder="conv_pallas": a Predictor on the
   kernels (the conv kernel for the image tower, the MLP kernels for the
   trajectory tower) against the same weights on the plain path
   (encoder="conv", no kernels), every verb at batches 1 to 1024 (rtol =
   atol = 1e-4, fp32); the conv kernel's serving count, reset just before
   the requests, must be positive after them; image→trajectory p50/p95 of
   both paths at buckets 1 to 1024.
5. Times: Predictor.cross_generate image→trajectory p50/p95 per bucket for
   both paths, and each tower's device time (CUDA events) against its plain
   twin at every bucket and at B = 16384 in the served dtype, and in bf16
   at B = 1024 and 16384.
6. The training kernels against their plain twins on the card: the tower
   forward (injected and seeded ε), the decoder+loss backward, the encoder
   backward and the weight-gradient kernel, for the config-3 towers and a
   conditional image tower (n_cond=10), batches 1 to 16384, fp32
   (rtol = atol = 1e-4) and bf16 (2e-2); a gradient summed over the batch
   takes atol = tol × max|want|. The weight-gradient kernel also runs on
   widths that are not multiples of 4 (the conditional tower's 510 × 794);
   it, the tower forward (every output, with injected and with seeded ε),
   the decoder+loss backward (dz and the six weight grads) and the encoder
   backward give identical bits on a second call, and the encoder backward
   without dx gives the same weight grads bit for bit. The batches take
   every row tile of the kernels on the block-tiled product (16, 32 and 64
   rows a block; 16 rows also shared by two blocks): the plans of the
   forward kernels (the tower's and the stacks') and of the backward
   kernels are printed with their shared memory.
6b. The composable training path's kernels against their twins on the
   card: the decoder backward (image, trajectory, conditional and depth-3
   decoders, fp32 and bf16; identical bits on a second call, and the same
   weight grads without dz; its plans printed), the sampler (ε at rtol =
   atol = 1e-6, z) and the joint loss forward and backward (kinds
   bernoulli + gaussian, with and without the association column), batches
   1 to 16384.
6c. The conv kernels against their twins on the card, batches 1 to 16384,
   fp32 and bf16: conv_fwd on all four layer shapes of the conv tower, as
   the layer's forward and as its input gradient (the four uses of the
   primitive), conv_dw on all four, conv_enc (every output) and conv_dec
   (every output, kinds bernoulli and gaussian); conv_fwd, conv_dw,
   conv_enc and conv_dec give identical bits on a second call. The batches
   take every row tile of conv_enc (16, 32 and 64 rows a block), printed
   with its shared memory.
7. Training, the port's second main path: config 3 at full width from
   seed 0, trained through train_loop on the kernels (use_pallas="mega")
   and on the plain path. Step-0 gradients agree within phase 6's
   tolerances, the per-step total over 20 steps within rtol 1e-3, the loss
   falls over 200 steps, and the training kernels' launch counts are reset
   just before the kernel-path run and must all be positive after it;
   decode_mlp_fused's backward on the card matches its twin.
7b. Training, the third main path: config 5 on one card through
   train_loop on the composable kernels (use_pallas=True), the megakernel
   and the plain path, from one seed (so one ε). bf16 step-0 totals and
   gradients agree within phase 6's bf16 tolerances; config 5 as it is
   trains 200 steps with exactly the per-step launch counts of
   COMPOSABLE_PER_STEP (counts reset just before) and its loss falls; the
   20-step per-step totals agree within rtol 1e-3 in fp32 (config 5 at
   fp32, and config 3); a depth-3 image tower under "mega" warns
   MegaFallbackWarning and trains on the composable kernels.
7c. Training config 4 (batch 64, fp32) from one seed (so one ε): with
   encoder="conv_pallas" on the mega, composable and plain paths, step-0
   totals and gradients agree with the plain path (encoder="conv", no
   kernels) within phase 6's tolerances in fp32 and bf16; each path, and
   config 4 as it ships (encoder="conv", "mega"), trains 200 steps with
   exactly the per-step launch counts of CONV_PER_STEP or SHIPPED_PER_STEP
   (counts reset just before), its first 20 per-step totals agree with the
   plain path's within rtol 1e-3, and its loss falls; the plain path's
   samples/s is printed. Config 4 as it ships and on the plain path (plain
   F.conv2d on the image tower) takes 5 steps twice from two copies of one
   state and must give identical bits in every parameter and every total.
7d. Training baseline configs 1 (image only) and 2 (trajectory only), one
   modality and lambda = 0, at full width from one seed on the mega and
   composable paths against the plain path: step-0 totals and gradients
   within phase 6's tolerances, 200 steps with exactly ONE_TOWER_PER_STEP's
   launches, 20-step curves within rtol 1e-3, and the loss falls.
8. Times: train_loop_fused samples/s, interleaved plain first and last, at
   batch 16384 bf16 (steps_per_call=4) and batch 64 fp32 (mega and plain
   paths), and at config 5's settings (all three paths), on 65,536
   synthetic pairs featurized on the card; and each training kernel's
   time per call against its twin's (and, for the weight-gradient kernel,
   torch.matmul's; for the decoder+loss backward and the stack backward,
   also without their weight-gradient launches, and for the stack backward
   also without dx, each beside its bound), fp32 and bf16: CUDA events
   around the calls,
   and the device's busy time from torch.profiler, which leaves out the
   device waiting for the host (what the JSON record reports where the
   profiler measured it).
8d. Times of config 4: train_loop_fused samples/s at batch 64 fp32 and
   batch 2048 bf16 on the plain, conv mega, conv_pallas mega and
   conv_pallas composable paths in turns, plain first and last; at B = 1024
   and 16384, fp32 and bf16, conv_fwd in all eight uses (each layer's
   forward and input gradient) and conv_dw on all four layers, each against
   its twin and one cuDNN call checked to compute the same function in fp32
   (F.conv2d, F.conv_transpose2d, torch.nn.grad.conv2d_input or
   torch.nn.grad.conv2d_weight); conv_enc and conv_dec (fp32 and bf16)
   against their twins.
9. The user-facing path on config 3 at full width from seed 0, on 4096
   synthetic pairs featurized on the card (twice, to identical bits; the
   digests of the strokes and pairs printed): AssocVariationalAutoEncoder
   takes 30 partial_fit steps (batch 64, fp32) on the mega, composable and
   plain paths, the kernel paths' costs within rtol 1e-3 of plain, the
   cost falling, each path's training kernels launched (counts reset just
   before) and none on plain; save_model, partial_fit, restore_model,
   partial_fit give identical costs, and a fresh process that loads the
   saved directory and fits the same batch gives that cost's bits too;
   AssocVariationalAutoEncoder.load,
   Predictor.load(step=), Predictor.from_checkpoint and
   Predictor.from_model give the live model's cross_generate in both
   directions (rtol = atol = 1e-4), and the from_model predictor does not
   change with a further partial_fit; evaluate, eval_metrics,
   recognition_accuracy and marginal_log_likelihood (64 draws, 4096 rows)
   on the saved weights on "mega", True and False from one seed: MSE, loss
   terms, ELBO and IWAE within rtol = atol = 1e-4 of plain, k-NN within
   0.01, IWAE >= ELBO, each function's forward kernels launched (counts
   reset before each call) and none on plain; dec_fwd at the MLL's 32768
   rows against its twin in fp32 and bf16, twice for identical bits, and
   timed; `python -m vae_assoc_tpu_torch.evaluate` as a subprocess exits 0
   with every key of the JAX package's vae-assoc-eval output, all finite.
   Prints partial_fit steps/s, each eval function's wall seconds per
   setting and the CLI's.
10. The data surface on config 3 at full width: the UJI fixture
   (tests/fixtures/ujipenchars2_format.txt, 240 characters) parsed by the
   native parser (built here with g++) and by the Python one, bit for bit;
   featurized on the card with the resample and the RBF encoding (100
   centers), each twice, and an augmented view twice from one generator
   seed, to identical bits (digests printed), and against the CPU's
   features (rtol = atol = 1e-4; RBF weights compared through their
   reconstructions); train_loop on the mega path, batch 64 fp32, 40 epochs
   with a refresh_data hook that featurizes an augmented view each epoch:
   exactly 2 mega_fwd, 2 mega_dec_loss_bwd, 2 enc_bwd and 14 wgrad
   launches a step (counts reset just before), twice from one state to
   identical bits, the loss falling, per-epoch totals within rtol 1e-3 of
   the plain path's; per encoding, save_model with model_config.json's
   "data" section, `python -m vae_assoc_tpu_torch.evaluate DIR --data uji`
   as a subprocess, every value within rtol = atol = 1e-4 of train/eval.py
   in process (k-NN 0.01), and a contradicting --traj-encoding exits
   non-zero; stream_train over 65,536 synthetic pairs at batch 16384 bf16
   (mega, 1 epoch) gives the bits of a synchronous loop over the same
   slices. Prints the parser's build and parse seconds, steps/s, the CLI's
   wall seconds, and stream_train's samples/s beside train_loop_fused's.

The line before the last is the kernel record as JSON, each kernel with
its bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over 67 TFLOP/s (fp32, no tensor cores) or, for a bf16 call,
989 TFLOP/s (tensor cores), the H100 SXM data sheet's rates. The kernels
with a bf16 route on tensor cores (enc_fwd, dec_fwd, mega_fwd,
mega_dec_loss_bwd, wgrad, conv_fwd, conv_dw, conv_enc, conv_dec, enc_bwd,
dec_bwd) also carry a "bf16" object with the same fields; the times of
mega_dec_loss_bwd, enc_bwd and dec_bwd include their weight-gradient
launches, and "alone_ms" is the kernel's without them; "eval_launches" is
the kernel's launches in phase 9's evaluation, "uji_launches" in phase
10's training and in-process evaluation; enc_bwd and dec_bwd
also give "nodx_ms" and
"nodx_bound_ms", with their weight-gradient launches but without dx. The
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside this file, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

BATCHES = (1, 7, 64, 257, 1024, 4096)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BUCKETS = (1, 64, 256, 1024, 4096)
TIMED_BATCH = 1024  # the shape of the JSON kernel record (ModelServer's max_batch)
SOURCE = "vae_assoc_tpu_torch/kernels/csrc/mlp_fwd.cu"
TRAIN_BATCHES = (1, 7, 64, 257, 1024, 4096, 16383, 16384)
TRAIN_TIMED = (1024, 16384)
CSRC = "vae_assoc_tpu_torch/kernels/csrc/"
EPS_TOL = 1e-6  # the sampler against its twin: the same integers, then expf/logf/cosf
COMPOSABLE_PER_STEP = {"enc_fwd": 2, "reparam": 2, "dec_fwd": 2, "loss_fwd": 1,
                       "loss_bwd": 1, "dec_bwd": 2, "enc_bwd": 2, "wgrad": 14}
"""Hand-written launches per step of the composable path on two depth-2
towers: 3 weight-gradient launches per decoder, 4 per encoder."""
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _max_err(got: torch.Tensor, want: torch.Tensor, tol: float):
    diff = (got - want).abs()
    ok = bool((diff <= tol + tol * want.abs()).all()) and bool(torch.isfinite(got).all())
    return float(diff.max()), ok


@torch.inference_mode()
def check_kernels(rng):
    """Phase 3; returns {(stack, batch, dtype): max_abs_err}."""
    from vae_assoc_tpu_torch.configs import default_image_arch, default_traj_arch
    from vae_assoc_tpu_torch.kernels import mlp as kmlp
    from vae_assoc_tpu_torch.models.networks import init_mlp_vae_params

    archs = {
        "image": (default_image_arch(), 0),
        "trajectory": (default_traj_arch(), 0),
        "image_depth3": (default_image_arch(depth=3), 0),
        "image_cond10": (default_image_arch(), 10),
    }
    errs, failed = {}, []
    for name, (arch, n_cond) in archs.items():
        gen = torch.Generator().manual_seed(1)
        m = init_mlp_vae_params(gen, arch, device="cuda", n_cond=n_cond)
        for cd, tol in TOL.items():
            for kind in ("enc", "dec"):
                line = []
                for b in BATCHES:
                    if kind == "enc":
                        x = torch.from_numpy(rng.uniform(
                            0, 1, (b, arch["n_input"] + n_cond)).astype(np.float32)).cuda()
                        got = kmlp.encode_mlp_fused(m, x, compute_dtype=cd)
                        again = kmlp.encode_mlp_fused(m, x, compute_dtype=cd)
                        want = kmlp.encode_mlp_plain(m, x, compute_dtype=cd)
                    else:
                        z = torch.from_numpy(rng.normal(
                            size=(b, arch["n_z"] + n_cond)).astype(np.float32)).cuda()
                        got = (kmlp.decode_mlp_fused(m, z, compute_dtype=cd),)
                        again = (kmlp.decode_mlp_fused(m, z, compute_dtype=cd),)
                        want = (kmlp.decode_mlp_plain(m, z, compute_dtype=cd),)
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, a) for g, a in zip(got, again)):
                        failed.append(f"{name} {kind} B={b} {cd}: two calls differ")
                    res = [_max_err(g, w, tol) for g, w in zip(got, want)]
                    err = max(e for e, _ in res)
                    errs[(f"{name}_{kind}", b, cd)] = err
                    line.append(f"B={b}:{err:.2e}")
                    if not all(ok for _, ok in res):
                        failed.append(f"{name} {kind} B={b} {cd} err={err:.3e}")
                print(f"check {name} {kind}_fwd {cd} (rtol=atol={tol}): "
                      + " ".join(line), flush=True)
    if failed:
        raise AssertionError("kernel disagrees with its plain twin: "
                             + "; ".join(failed))
    return errs


def _close(got, want, tol, summed=False):
    """(max abs err, ok) under rtol = tol and atol = tol, or, for a sum over
    the batch, atol = tol × max|want|."""
    atol = tol * max(float(want.abs().max()), 1e-30) if summed else tol
    diff = (got - want).abs()
    ok = bool((diff <= atol + tol * want.abs()).all()) and bool(torch.isfinite(got).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def _recorder(errs, failed):
    """record(key, [(name, got, want, summed), ...], tol): stores the worst
    max abs err in errs[key] and returns it; each disagreement goes to
    ``failed``."""
    def record(key, pairs, tol):
        worst = 0.0
        for name, got, want, summed in pairs:
            err, ok = _close(got, want, tol, summed)
            worst = max(worst, err)
            if not ok:
                failed.append(f"{key} {name} err={err:.3e}")
        errs[key] = worst
        return worst

    return record


def _same_bits(what, got, again, nodx):
    """Disagreements of a stack backward's (grads, dx) with a second call
    (every bit of dx and the grads) and with a call without dx (dx None,
    every bit of the grads)."""
    flat = [t for pair in got[0] for t in pair]
    bad = []
    if not (torch.equal(got[1], again[1]) and all(
            torch.equal(g, a) for g, a in zip(flat, [t for pair in again[0] for t in pair]))):
        bad.append(f"{what}: two calls differ")
    if nodx[1] is not None or not all(
            torch.equal(g, n) for g, n in zip(flat, [t for pair in nodx[0] for t in pair])):
        bad.append(f"{what}: the grads without dx differ")
    return bad


def _forward_bits(what, got, again):
    """Disagreements of a forward kernel's outputs with a second call's."""
    torch.cuda.synchronize()
    return [] if all(torch.equal(g, a) for g, a in zip(got, again)) else [
        f"{what}: two calls differ"]


def _forward_plans(km, kmlp, batches, n_sm):
    """The forward kernels' plans per batch on the image tower (the tower's
    and the stacks'), as one printed line each."""
    plans = {
        "mega_fwd": lambda b, cd: km.fwd_plan((784, 500, 500, 20, 0, 500, 500, 784), b, n_sm, cd),
        "enc_fwd": lambda b, cd: kmlp.stack_fwd_plan((500, 500, 20, 20), b, n_sm, cd),
        "dec_fwd": lambda b, cd: kmlp.stack_fwd_plan((500, 500, 784), b, n_sm, cd),
    }
    lines = []
    for name, plan in plans.items():
        def one(b):
            rows, f32, parts = plan(b, "float32")
            return f"B={b}: {rows} x {parts} ({f32}, {plan(b, 'bfloat16')[1]})"

        lines.append(f"{name} image rows per block x blocks sharing them (fp32 and bf16 "
                     "shared memory in bytes): " + ", ".join(one(b) for b in batches))
    return lines


def _stack_plans(kmlp, widths, batches, n_sm):
    """The stack backward's plan per batch, as one printed line."""
    def plan(b):
        rows, f32, parts = kmlp.stack_bwd_plan(widths, b, n_sm)
        bf16 = kmlp.stack_bwd_plan(widths, b, n_sm, "bfloat16")[1]
        return f"B={b}: {rows} x {parts} ({f32}, {bf16})"

    return ("rows per block x blocks sharing them (fp32 and bf16 shared memory in bytes): "
            + ", ".join(plan(b) for b in batches))


def _grads_close(names, got, want, tol):
    """(max abs err, disagreeing tensors) of two lists of batch-summed grads."""
    worst, bad = 0.0, []
    for key, g, w in zip(names, got, want):
        err, ok = _close(g, w, tol, summed=True)
        worst = max(worst, err)
        if not ok:
            bad.append(f"{key} err={err:.3e}")
    return worst, bad


def train_archs():
    from vae_assoc_tpu_torch.configs import default_image_arch, default_traj_arch

    return {
        "image": (default_image_arch(), 0, "bernoulli"),
        "trajectory": (default_traj_arch(), 0, "gaussian"),
        "image_cond10": (default_image_arch(), 10, "bernoulli"),
    }


@torch.no_grad()
def check_train_kernels(rng, batches=TRAIN_BATCHES):
    """Phase 6; returns {(kernel, tower, batch, dtype): max_abs_err}."""
    from vae_assoc_tpu_torch.kernels import megakernel as km
    from vae_assoc_tpu_torch.kernels import mlp as kmlp
    from vae_assoc_tpu_torch.models.networks import init_mlp_vae_params
    from vae_assoc_tpu_torch.ops.sampling import philox_normal

    errs, failed = {}, []
    record = _recorder(errs, failed)
    for tower, (arch, n_cond, kind) in train_archs().items():
        gen = torch.Generator().manual_seed(2)
        m = init_mlp_vae_params(gen, arch, device="cuda", n_cond=n_cond)
        flat = [t.detach() for t in km.flatten(m)]
        n_x, n_z = arch["n_input"], arch["n_z"]
        for cd, tol in TOL.items():
            line = {k: [] for k in ("mega_fwd", "mega_fwd_seeded", "mega_dec_loss_bwd",
                                    "enc_bwd", "wgrad")}
            for b in batches:
                x = rng.uniform(0, 1, (b, n_x)).astype(np.float32)
                if kind == "gaussian":
                    x = rng.normal(size=(b, n_x)).astype(np.float32)
                if n_cond:
                    x = np.concatenate([x, np.eye(n_cond, dtype=np.float32)[
                        rng.integers(0, n_cond, b)]], axis=1)
                x = torch.from_numpy(x).cuda()
                eps = torch.from_numpy(rng.normal(size=(b, n_z)).astype(np.float32)).cuda()
                names = ("mu", "lv", "eps", "rec", "kl")
                got = km.tower_fwd(flat, x, kind=kind, eps=eps, compute_dtype=cd)
                want = km.tower_fwd_plain(flat, x, eps, kind=kind, compute_dtype=cd)
                failed += _forward_bits(f"mega_fwd {tower} B={b} {cd}", got, km.tower_fwd(
                    flat, x, kind=kind, eps=eps, compute_dtype=cd))
                line["mega_fwd"].append(record(
                    ("mega_fwd", tower, b, cd),
                    [(n, g, w, False) for n, g, w in zip(names, got, want)], tol))
                seed = 1000 + b
                got = km.tower_fwd(flat, x, kind=kind, seed=seed, compute_dtype=cd)
                want = km.tower_fwd_plain(flat, x, philox_normal(seed, b, n_z, "cuda"),
                                          kind=kind, compute_dtype=cd)
                failed += _forward_bits(f"mega_fwd seeded {tower} B={b} {cd}", got, km.tower_fwd(
                    flat, x, kind=kind, seed=seed, compute_dtype=cd))
                line["mega_fwd_seeded"].append(record(
                    ("mega_fwd_seeded", tower, b, cd),
                    [(n, g, w, False) for n, g, w in zip(names, got, want)], tol))
                mu, lv = want[0], want[1]
                z = mu + torch.exp(0.5 * lv) * want[2]
                grec = torch.from_numpy(rng.uniform(0.5, 1.5, b).astype(np.float32)).cuda() / b
                got = km.dec_loss_bwd(x, z, flat[8:], grec, kind=kind, compute_dtype=cd)
                want = km.dec_loss_bwd_plain(x, z, flat[8:], grec, kind=kind, compute_dtype=cd)
                again = km.dec_loss_bwd(x, z, flat[8:], grec, kind=kind, compute_dtype=cd)
                torch.cuda.synchronize()
                if not all(torch.equal(g, a) for g, a in zip([got[0], *got[1]],
                                                             [again[0], *again[1]])):
                    failed.append(f"mega_dec_loss_bwd {tower} B={b} {cd}: two calls differ")
                pairs = [("dz", got[0], want[0], False)]
                pairs += [(f"grad{i}", g, w, True) for i, (g, w) in enumerate(zip(got[1], want[1]))]
                line["mega_dec_loss_bwd"].append(record(("mega_dec_loss_bwd", tower, b, cd), pairs, tol))
                dmu = torch.from_numpy(rng.normal(size=(b, n_z)).astype(np.float32)).cuda() / b
                dlv = torch.from_numpy(rng.normal(size=(b, n_z)).astype(np.float32)).cuda() / b
                layers = kmlp._pairs(flat[:8])
                args = (layers[:2], layers[2:], x, dmu, dlv)
                got = kmlp.encode_bwd(*args, compute_dtype=cd)
                want = kmlp.encode_bwd_plain(*args, compute_dtype=cd)
                failed += _same_bits(f"enc_bwd {tower} B={b} {cd}", got,
                                     kmlp.encode_bwd(*args, compute_dtype=cd),
                                     kmlp.encode_bwd(*args, compute_dtype=cd, want_dx=False))
                pairs = [("dx", got[1], want[1], False)]
                for i, (g, w) in enumerate(zip(got[0], want[0])):
                    pairs += [(f"dw{i}", g[0], w[0], True), (f"db{i}", g[1], w[1], True)]
                line["enc_bwd"].append(record(("enc_bwd", tower, b, cd), pairs, tol))
                # The conditional tower's widths (510, 794) are not multiples
                # of 4: the kernel's one-by-one loads.
                a = torch.from_numpy(rng.uniform(0, 1, (b, 500 + n_cond)).astype(np.float32)).cuda()
                d = torch.from_numpy(rng.normal(size=(b, n_x + n_cond)).astype(np.float32)).cuda()
                got = kmlp.weight_grads(a, d, compute_dtype=cd)
                want = kmlp.weight_grads_plain(a, d, compute_dtype=cd)
                again = kmlp.weight_grads(a, d, compute_dtype=cd)
                torch.cuda.synchronize()
                line["wgrad"].append(record(
                    ("wgrad", tower, b, cd),
                    [("dw", got[0], want[0], True), ("db", got[1], want[1], True)], tol))
                if not all(torch.equal(g, r) for g, r in zip(got, again)):
                    failed.append(f"wgrad {tower} B={b} {cd}: two calls differ")
            for k, v in line.items():
                print(f"check {tower} {k} {cd} (tol {tol}): " + " ".join(
                    f"B={b}:{e:.2e}" for b, e in zip(batches, v)), flush=True)
    n_sm = kmlp.sm_count(torch.device("cuda", 0))

    def plan(b):
        rows, f32 = km.dec_bwd_plan(b, n_sm)
        return (f"B={b}: {rows} x {km.dec_bwd_parts(b, rows, n_sm)} "
                f"({f32}, {km.dec_bwd_plan(b, n_sm, 'bfloat16')[1]})")

    print("mega_dec_loss_bwd rows per block x blocks sharing them (fp32 and bf16 shared "
          "memory in bytes): " + ", ".join(plan(b) for b in batches), flush=True)
    print("enc_bwd " + _stack_plans(kmlp, [500, 500], batches, n_sm), flush=True)
    for line in _forward_plans(km, kmlp, batches, n_sm):
        print(line, flush=True)
    if failed:
        raise AssertionError("training kernel disagrees with its plain twin: "
                             + "; ".join(failed[:20]))
    return errs


LOSS_KINDS = ("bernoulli", "gaussian")


def _loss_inputs(rng, b, widths=(784, 200), n_z=20):
    """Config-3-shaped joint-loss inputs on the card: xs, recons, μs, logσ²s."""
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()

    xs = [t(rng.uniform(0, 1, (b, widths[0]))), t(rng.normal(size=(b, widths[1])))]
    recons = [t(3 * rng.normal(size=(b, w))) for w in widths]
    mus = [t(rng.normal(size=(b, n_z))) for _ in widths]
    lvs = [t(0.5 * rng.normal(size=(b, n_z))) for _ in widths]
    return xs, recons, mus, lvs


@torch.no_grad()
def check_composable_kernels(rng, batches=TRAIN_BATCHES):
    """Phase 6b; returns {(kernel, case, batch, dtype): max_abs_err}."""
    from vae_assoc_tpu_torch.configs import default_image_arch
    from vae_assoc_tpu_torch.kernels import loss as kloss
    from vae_assoc_tpu_torch.kernels import mlp as kmlp
    from vae_assoc_tpu_torch.kernels import sampling as ksamp
    from vae_assoc_tpu_torch.models.networks import hidden_layers, init_mlp_vae_params

    errs, failed = {}, []
    record = _recorder(errs, failed)
    towers = dict(train_archs())
    towers["image_depth3"] = (default_image_arch(depth=3), 0, "bernoulli")
    for tower, (arch, n_cond, _) in towers.items():
        m = init_mlp_vae_params(torch.Generator().manual_seed(3), arch, device="cuda",
                                n_cond=n_cond)
        hidden, head = hidden_layers(m.gener), m.gener["out"]
        n_in, n_out = arch["n_z"] + n_cond, arch["n_input"]
        for cd, tol in TOL.items():
            line = []
            for b in batches:
                z = torch.from_numpy(rng.normal(size=(b, n_in)).astype(np.float32)).cuda()
                dout = torch.from_numpy(rng.normal(size=(b, n_out)).astype(np.float32)).cuda() / b
                got = kmlp.decode_bwd(hidden, head, z, dout, compute_dtype=cd)
                want = kmlp.decode_bwd_plain(hidden, head, z, dout, compute_dtype=cd)
                failed += _same_bits(f"dec_bwd {tower} B={b} {cd}", got,
                                     kmlp.decode_bwd(hidden, head, z, dout, compute_dtype=cd),
                                     kmlp.decode_bwd(hidden, head, z, dout, compute_dtype=cd,
                                                     want_dx=False))
                pairs = [("dz", got[1], want[1], False)]
                for i, (g, w) in enumerate(zip(got[0], want[0])):
                    pairs += [(f"dw{i}", g[0], w[0], True), (f"db{i}", g[1], w[1], True)]
                line.append(record(("dec_bwd", tower, b, cd), pairs, tol))
            print(f"check {tower} dec_bwd {cd} (tol {tol}): " + " ".join(
                f"B={b}:{e:.2e}" for b, e in zip(batches, line)), flush=True)
    print("dec_bwd " + _stack_plans(kmlp, [500, 500], batches,
                                    kmlp.sm_count(torch.device("cuda", 0))), flush=True)

    line = {"reparam": [], "loss_fwd": [], "loss_bwd": []}
    for b in batches:
        mu = torch.from_numpy(rng.normal(size=(b, 20)).astype(np.float32)).cuda()
        lv = torch.from_numpy(0.5 * rng.normal(size=(b, 20)).astype(np.float32)).cuda()
        got = ksamp.reparameterize_kernel(mu, lv, 7000 + b)
        want = ksamp.reparameterize_plain(mu, lv, 7000 + b)
        torch.cuda.synchronize()
        line["reparam"].append(record(("reparam", "n_z=20", b, "float32"),
                                      [("z", got[0], want[0], False),
                                       ("eps", got[1], want[1], False)], EPS_TOL))
        for with_assoc in (True, False):
            args = _loss_inputs(rng, b)
            case = f"assoc={with_assoc}"
            got = kloss.loss_terms(LOSS_KINDS, *args, with_assoc=with_assoc)
            want = kloss.loss_terms_plain(LOSS_KINDS, *args, with_assoc=with_assoc)
            torch.cuda.synchronize()
            line["loss_fwd"].append(record(("loss_fwd", case, b, "float32"),
                                           [("terms", got, want, False)], TOL["float32"]))
            g = torch.from_numpy(rng.uniform(0.5, 1.5, (b, 4 + with_assoc))
                                 .astype(np.float32)).cuda() / b
            got = kloss.loss_terms_bwd(LOSS_KINDS, g, *args, with_assoc=with_assoc)
            want = kloss.loss_terms_bwd_plain(LOSS_KINDS, g, *args, with_assoc=with_assoc)
            torch.cuda.synchronize()
            pairs = [(f"{n}{i}", gg, ww, False) for n, gs, ws in zip(("drecon", "dmu", "dlv"),
                                                                     got, want)
                     for i, (gg, ww) in enumerate(zip(gs, ws))]
            line["loss_bwd"].append(record(("loss_bwd", case, b, "float32"), pairs,
                                           TOL["float32"]))
    for k, v in line.items():
        print(f"check {k} float32: " + " ".join(f"{e:.2e}" for e in v)
              + f" (B = {', '.join(map(str, batches))}"
              + ("; with and without the association column)" if k != "reparam" else ")"),
              flush=True)
    if failed:
        raise AssertionError("composable-path kernel disagrees with its plain twin: "
                             + "; ".join(failed[:20]))
    return errs


def train_and_check(card):
    """Phase 7; returns the training kernels' launch counts of the main path
    and its per-step totals."""
    import dataclasses

    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.data.synthetic import generate_raw_strokes
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.kernels import mlp as kmlp
    from vae_assoc_tpu_torch.models import assoc as assoc_mod
    from vae_assoc_tpu_torch.models.networks import hidden_layers
    from vae_assoc_tpu_torch.train import init_train_state, train_loop

    cfg, tc = baseline_config(3)
    paths = {"kernel": dataclasses.replace(tc, use_pallas="mega"),
             "plain": dataclasses.replace(tc, use_pallas=False)}
    tol = TOL[tc.compute_dtype]
    # One batch of 64 synthetic pairs featurized on the card, so that each
    # train_loop epoch is one step and its history is the per-step total.
    data = list(PairedDataset.from_synthetic(tc.batch_size, seed=0, device="cuda").features())
    model = assoc_mod.init_assoc(0, cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"training: baseline config 3, {n_params} parameters, batch "
          f"{tc.batch_size}, compute_dtype={tc.compute_dtype}", flush=True)

    grads = {}
    for name, t in paths.items():
        total, _ = assoc_mod.assoc_loss_fn(model, data, cfg, seed=123, use_pallas=t.use_pallas)
        grads[name] = torch.autograd.grad(total, list(model.parameters()))
    torch.cuda.synchronize()
    names = [key for key, _ in model.named_parameters()]
    worst, bad = _grads_close(names, grads["kernel"], grads["plain"], tol)
    print(f"step-0 grads, kernel vs plain path: {len(grads['plain'])} tensors, max abs "
          f"err {worst:.3e} (rtol {tol}, atol {tol} x max|want|)", flush=True)
    assert not bad, "step-0 grads disagree: " + "; ".join(bad)
    # decode_mlp_fused has a backward on the card: its gradients against the twin's.
    img = model.modalities[0]
    z = torch.randn(5, 20, device="cuda", requires_grad=True)
    (kmlp.decode_mlp_fused(img, z, compute_dtype=tc.compute_dtype) ** 2).sum().backward()
    with torch.no_grad():
        g_out = 2 * kmlp.decode_mlp_plain(img, z, compute_dtype=tc.compute_dtype)
        want_grads, want_dz = kmlp.decode_bwd_plain(
            hidden_layers(img.gener), img.gener["out"], z, g_out,
            compute_dtype=tc.compute_dtype)
    err, ok = _close(z.grad, want_dz, tol)
    err_w, ok_w = _close(img.gener["h1"].w.grad, want_grads[0][0], tol, summed=True)
    print(f"decode_mlp_fused backward on the card vs twin: dz {err:.3e}, dW1 {err_w:.3e}",
          flush=True)
    assert ok and ok_w, "decode_mlp_fused's backward disagrees with its twin"
    model.zero_grad(set_to_none=True)

    hist, launches = {}, None
    for name in ("plain", "kernel"):
        state = init_train_state(cfg, paths[name], device="cuda")
        if name == "kernel":
            reset_launches()
        state, h = train_loop(cfg, paths[name], data, epochs=20, state=state)
        if name == "kernel":
            launches = launch_counts()
            kernel_state = state
        hist[name] = [e["total"] for e in h]
    print(f"launches during the 20 kernel-path steps: {launches}", flush=True)
    for k in ("mega_fwd", "mega_dec_loss_bwd", "enc_bwd", "wgrad"):
        assert launches[k] > 0, f"kernel {k} was not launched by the training path"
    # The weights themselves are not compared: where a gradient is near
    # zero, Adam's first steps divide it by its own root mean square, so a
    # rounding-level difference between the two paths becomes a difference
    # of a full learning rate in that weight. The loss curve is what the
    # two paths must share.
    k, p = np.array(hist["kernel"]), np.array(hist["plain"])
    print("per-step total, kernel path: " + " ".join(f"{v:.4f}" for v in k), flush=True)
    print("per-step total, plain path:  " + " ".join(f"{v:.4f}" for v in p), flush=True)
    rel = float(np.max(np.abs(k - p) / np.abs(p)))
    print(f"20-step loss curves agree to max rel err {rel:.3e} (rtol 1e-3)", flush=True)
    assert np.isfinite(k).all() and rel <= 1e-3, "loss curves disagree"
    _, h = train_loop(cfg, paths["kernel"], data, epochs=180, state=kernel_state)
    print(f"kernel path: total {k[0]:.4f} at step 0, {h[-1]['total']:.4f} at step 200",
          flush=True)
    assert h[-1]["total"] < k[0], "the loss did not fall over 200 steps"
    return launches


PATHS = {"composable": True, "mega": "mega", "plain": False}


def _curves(cfg, tc, data, steps=20):
    """Per-step totals of ``steps`` steps of train_loop from tc.seed's state
    on each path; ``data`` is one batch, so an epoch is one step."""
    import dataclasses

    from vae_assoc_tpu_torch.train import train_loop

    out = {}
    for name, up in PATHS.items():
        t = dataclasses.replace(tc, use_pallas=up, steps_per_call=1)
        _, h = train_loop(cfg, t, data, epochs=steps, device="cuda")
        out[name] = np.array([e["total"] for e in h])
    return out


def _compare_curves(label, curves, against):
    c = curves["composable"]
    assert np.isfinite(c).all(), f"{label}: the composable path's loss is not finite"
    print(f"{label}, per-step total, composable path: " + " ".join(f"{v:.4f}" for v in c),
          flush=True)
    for other in against:
        rel = float(np.max(np.abs(c - curves[other]) / np.abs(curves[other])))
        print(f"{label}: 20-step curve of the composable path vs {other}: max rel err "
              f"{rel:.3e} (rtol 1e-3)", flush=True)
        assert rel <= 1e-3, f"{label}: composable and {other} loss curves disagree"


def train_composable_and_check(card):
    """Phase 7b; returns the composable path's launch counts over config 5's
    200 steps."""
    import dataclasses
    import warnings

    from vae_assoc_tpu_torch.configs import baseline_config, default_image_arch
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.data.synthetic import generate_raw_strokes
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.models import assoc as assoc_mod
    from vae_assoc_tpu_torch.train import init_train_state, train_loop

    cfg, tc = baseline_config(5)
    bs, spc = tc.batch_size, tc.steps_per_call
    print(f"training: baseline config 5 on one card, batch {bs}, steps_per_call {spc}, "
          f"compute_dtype={tc.compute_dtype}, use_pallas={tc.use_pallas}", flush=True)
    batch = list(PairedDataset.from_synthetic(bs, seed=0, device="cuda").features())
    model = assoc_mod.init_assoc(0, cfg, device="cuda")
    params = list(model.parameters())
    tol = TOL[tc.compute_dtype]
    grads, totals = {}, {}
    for name, up in PATHS.items():
        total, _ = assoc_mod.assoc_loss_fn(model, batch, cfg, seed=123,
                                           compute_dtype=tc.compute_dtype, use_pallas=up)
        grads[name] = torch.autograd.grad(total, params)
        totals[name] = float(total.detach())
    torch.cuda.synchronize()
    names = [key for key, _ in model.named_parameters()]
    for other in ("plain", "mega"):
        worst, bad = _grads_close(names, grads["composable"], grads[other], tol)
        rel = abs(totals["composable"] - totals[other]) / abs(totals[other])
        print(f"config 5 bf16 step 0, composable vs {other}: total {totals['composable']:.4f} "
              f"vs {totals[other]:.4f} (rel {rel:.3e}); {len(params)} grads, max abs err "
              f"{worst:.3e} (rtol {tol}, atol {tol} x max|want|)", flush=True)
        assert rel <= tol and not bad, f"step-0 composable vs {other}: " + "; ".join(bad)

    # Config 5 as it is, 200 steps: the exact launches per step, and the loss falls.
    data = list(PairedDataset.from_synthetic(bs * spc, seed=1, device="cuda").features())
    state = init_train_state(cfg, tc, device="cuda")
    reset_launches()
    state, h = train_loop(cfg, tc, data, epochs=20, state=state)
    launches = launch_counts()
    steps = state.step
    print(f"launches during config 5's {steps} composable-path steps: {launches}", flush=True)
    want = {k: COMPOSABLE_PER_STEP.get(k, 0) * steps for k in launches}
    assert launches == want, f"launch counts {launches} != {want}"
    print(f"config 5 composable path: total {h[0]['total']:.4f} over steps 1-{spc}, "
          f"{h[-1]['total']:.4f} over steps {steps - spc + 1}-{steps}", flush=True)
    assert steps == 200 and h[-1]["total"] < h[0]["total"], "the loss did not fall"

    # fp32 curves: config 5 at fp32 against plain and mega; config 3 against plain.
    f32 = dataclasses.replace(tc, compute_dtype="float32")
    _compare_curves("config 5 fp32", _curves(cfg, f32, batch), ("plain", "mega"))
    cfg3, tc3 = baseline_config(3)
    batch3 = list(PairedDataset.from_synthetic(tc3.batch_size, seed=0, device="cuda").features())
    _compare_curves("config 3 fp32 batch 64", _curves(cfg3, tc3, batch3), ("plain",))

    # A depth-3 image tower under "mega" falls back to the composable kernels.
    img = dataclasses.replace(cfg3.modalities[0], arch=default_image_arch(depth=3))
    cfg_d3 = dataclasses.replace(cfg3, modalities=[img, cfg3.modalities[1]])
    tc_d3 = dataclasses.replace(tc3, use_pallas="mega")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reset_launches()
        state, h = train_loop(cfg_d3, tc_d3, batch3, epochs=3, device="cuda")
        fallback = launch_counts()
    n_warn = sum(w.category is assoc_mod.MegaFallbackWarning for w in caught)
    per_step = dict(COMPOSABLE_PER_STEP, wgrad=16)  # depth 3: 4 + 5 image, 3 + 4 trajectory
    want = {k: per_step.get(k, 0) * state.step for k in fallback}
    print(f"depth-3 image tower under 'mega': {n_warn} MegaFallbackWarning(s), launches "
          f"{fallback}, total {h[-1]['total']:.4f}", flush=True)
    assert n_warn == state.step == 3 and fallback == want and np.isfinite(h[-1]["total"])
    return launches


def time_training(card):
    """Phase 8a: train_loop_fused samples/s, kernel vs plain path, in turns;
    then config 5's settings on the composable, mega and plain paths."""
    import dataclasses

    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.train import train_loop_fused

    cfg, tc = baseline_config(3)
    t0 = time.perf_counter()
    data = list(PairedDataset.from_synthetic(65536, seed=0, device="cuda").features())
    torch.cuda.synchronize()
    print(f"65536 synthetic pairs generated and featurized in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rates = {}
    for label, kw, epochs in (
        ("batch 16384 bf16 steps_per_call=4",
         dict(batch_size=16384, compute_dtype="bfloat16", steps_per_call=4), 4),
        ("batch 64 fp32", dict(batch_size=64, compute_dtype="float32"), 1),
    ):
        tcs = {"kernel": dataclasses.replace(tc, use_pallas="mega", **kw),
               "plain": dataclasses.replace(tc, use_pallas=False, **kw)}
        for t in tcs.values():
            train_loop_fused(cfg, t, data, epochs=1, device="cuda")
        runs = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            _, h = train_loop_fused(cfg, tcs[name], data, epochs=epochs, device="cuda")
            assert np.isfinite(h[-1]["total"])
            runs[name].append(h[0]["samples_per_sec"])
        rates[label] = runs
        print(f"train_loop_fused {label}: kernel path "
              f"{' '.join(f'{v:.1f}' for v in runs['kernel'])} samples/s, plain path "
              f"{' '.join(f'{v:.1f}' for v in runs['plain'])} samples/s [{card}]", flush=True)

    cfg5, tc5 = baseline_config(5)
    tcs = {name: dataclasses.replace(tc5, use_pallas=up) for name, up in PATHS.items()}
    for t in tcs.values():
        train_loop_fused(cfg5, t, data, epochs=1, device="cuda")
    runs = {name: [] for name in tcs}
    for name in ("plain", "composable", "mega", "mega", "composable", "plain"):
        _, h = train_loop_fused(cfg5, tcs[name], data, epochs=2, device="cuda")
        assert np.isfinite(h[-1]["total"])
        runs[name].append(h[0]["samples_per_sec"])
    rates["config 5"] = runs
    print("train_loop_fused config 5 (batch 1024 bf16, steps_per_call=10): " + "; ".join(
        f"{name} path {' '.join(f'{v:.1f}' for v in r)} samples/s" for name, r in runs.items())
        + f" [{card}]", flush=True)
    return rates


def time_train_kernels(rng, card):
    """Phase 8b: device ms per launch of each training kernel (its wrapper,
    weight-gradient launches included) against its twin, image tower; the
    decoder+loss backward also alone (``alone``, without its three
    weight-gradient launches), the weight-gradient kernel also against one
    torch.matmul (``library``)."""
    from vae_assoc_tpu_torch.kernels import loss as kloss
    from vae_assoc_tpu_torch.kernels import megakernel as km
    from vae_assoc_tpu_torch.kernels import mlp as kmlp
    from vae_assoc_tpu_torch.kernels import sampling as ksamp
    from vae_assoc_tpu_torch.models.networks import init_mlp_vae_params

    arch, n_cond, kind = train_archs()["image"]
    m = init_mlp_vae_params(torch.Generator().manual_seed(2), arch, device="cuda")
    flat = [t.detach() for t in km.flatten(m)]
    layers = kmlp._pairs(flat[:8])
    dec = kmlp._pairs(flat[8:])
    times = {}
    with torch.no_grad():
        for cd in TOL:
            for b in TRAIN_TIMED:
                def t(*shape):
                    return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).cuda()
                x, eps, g = t(b, 784), t(b, 20), t(b) / b
                z, dmu, dlv, a, d = t(b, 20), t(b, 20) / b, t(b, 20) / b, t(b, 500), t(b, 784)
                dout = d / b
                cases = {
                    "mega_fwd": (lambda: km.tower_fwd(flat, x, kind=kind, eps=eps, compute_dtype=cd),
                                 lambda: km.tower_fwd_plain(flat, x, eps, kind=kind, compute_dtype=cd)),
                    "mega_dec_loss_bwd": (
                        lambda: km.dec_loss_bwd(x, z, flat[8:], g, kind=kind, compute_dtype=cd),
                        lambda: km.dec_loss_bwd_plain(x, z, flat[8:], g, kind=kind, compute_dtype=cd)),
                    "enc_bwd": (
                        lambda: kmlp.encode_bwd(layers[:2], layers[2:], x, dmu, dlv, compute_dtype=cd),
                        lambda: kmlp.encode_bwd_plain(layers[:2], layers[2:], x, dmu, dlv,
                                                      compute_dtype=cd)),
                    "wgrad": (lambda: kmlp.weight_grads(a, d, compute_dtype=cd),
                              lambda: kmlp.weight_grads_plain(a, d, compute_dtype=cd)),
                    "dec_bwd": (
                        lambda: kmlp.decode_bwd(dec[:2], dec[2], z, dout, compute_dtype=cd),
                        lambda: kmlp.decode_bwd_plain(dec[:2], dec[2], z, dout,
                                                      compute_dtype=cd)),
                }
                if cd == "float32":  # the sampler and the loss kernels are fp32 only
                    largs = _loss_inputs(rng, b)
                    gl = t(b, 5) / b
                    cases.update({
                        "reparam": (lambda: ksamp.reparameterize_kernel(dmu, dlv, 5),
                                    lambda: ksamp.reparameterize_plain(dmu, dlv, 5)),
                        "loss_fwd": (lambda: kloss.loss_terms(LOSS_KINDS, *largs),
                                     lambda: kloss.loss_terms_plain(LOSS_KINDS, *largs)),
                        "loss_bwd": (lambda: kloss.loss_terms_bwd(LOSS_KINDS, gl, *largs),
                                     lambda: kloss.loss_terms_bwd_plain(LOSS_KINDS, gl, *largs)),
                    })
                op = torch.bfloat16 if cd == "bfloat16" else torch.float32
                a_lib, d_lib = a.to(op), d.to(op)
                library = {"wgrad": lambda: torch.matmul(a_lib.T, d_lib)}
                # The backward kernels without their weight-gradient launches.
                alone = {
                    "mega_dec_loss_bwd": lambda: km._dec_loss_bwd_kernel(
                        x, z, flat[8:], g, kind, cd),
                    "enc_bwd": lambda: kmlp._stack_bwd_kernel(
                        "encoder-backward", layers[:2], layers[2:], x, [dmu, dlv], cd),
                    "dec_bwd": lambda: kmlp._stack_bwd_kernel(
                        "decoder-backward", dec[:2], dec[2:], z, [dout], cd),
                }
                # The stack backward as the training paths run it: no dx.
                nodx = {
                    "enc_bwd": lambda: kmlp.encode_bwd(layers[:2], layers[2:], x, dmu, dlv,
                                                       compute_dtype=cd, want_dx=False),
                    "dec_bwd": lambda: kmlp.decode_bwd(dec[:2], dec[2], z, dout,
                                                       compute_dtype=cd, want_dx=False),
                }
                stacks = {"enc_bwd": (IMAGE_ENC, 2), "dec_bwd": (IMAGE_DEC, 1)}
                for name, (kern, plain) in cases.items():
                    fns = {"kernel": kern, "plain": plain}
                    if name in library:
                        fns["library"] = library[name]
                    if name in alone:
                        fns["alone"] = alone[name]
                    if name in nodx:
                        fns["nodx"] = nodx[name]
                    bound = (_bound(*_wgrad_work(b), cd) if name == "wgrad"
                             else _bound(*_mega_fwd_work(b), cd) if name == "mega_fwd" else None)
                    if name in stacks:
                        bound = {which: _bound(*_stack_bwd_work(b, *stacks[name], **kw), cd)
                                 for which, kw in (("kernel", {}), ("alone", {"wgrad": False}),
                                                   ("nodx", {"dx": False}))}
                    times[(name, b, cd)] = _time_case(f"{name} image B={b} {cd}", fns, card,
                                                      bound, n=10)
    return times


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _profiled_ms(fn, n=10):
    """Device time per call of ``fn``: the own time of the CUDA kernels and
    copies it launches, summed over ``n`` calls by torch.profiler. Unlike
    CUDA events around the calls, this leaves out the time the device waits
    for the host. None when the profiler recorded fewer device activities
    than calls: each call launches at least one kernel, and the profiler
    has been seen to drop launches of the kernels in the ctypes library
    (all of a window's, or busy times near 3/5 of the CUDA events'), which
    would read as a shorter time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in device)
    return us / n / 1e3 if us > 0 and sum(e.count for e in device) >= n else None


# The conv tower's four layers: (cin, input size, cout, stride, dilate, pads,
# output size), as kernels/conv.py's layer ops call the conv kernel.
CONV_LAYERS = {
    "conv1": (1, 28, 32, 2, False, (0, 1), 14),
    "conv2": (32, 14, 64, 2, False, (0, 1), 7),
    "convt1": (64, 7, 32, 1, True, (2, 1), 14),
    "convt2": (32, 14, 1, 1, True, (2, 1), 28),
}
CONV_PER_STEP = {
    # conv_fwd: the dx of convt2, convt1 and conv2 (conv1's input is the data).
    "mega": {"conv_enc": 1, "conv_dec": 1, "conv_fwd": 3, "conv_dw": 4, "mega_fwd": 1,
             "mega_dec_loss_bwd": 1, "enc_bwd": 1, "wgrad": 7},
    # conv_fwd: the four layers forward, then the same three dx.
    "composable": {"conv_fwd": 7, "conv_dw": 4, "enc_fwd": 1, "dec_fwd": 1, "dec_bwd": 1,
                   "enc_bwd": 1, "wgrad": 7, "reparam": 2, "loss_fwd": 1, "loss_bwd": 1},
    "plain": {"conv_fwd": 7, "conv_dw": 4},
}
"""Hand-written launches per training step of config 4 with
encoder="conv_pallas", per use_pallas path: the image tower's conv kernels,
and the trajectory tower and the joint loss as on config 3's paths (3
weight-gradient launches for the trajectory decoder, 4 for its encoder)."""
SHIPPED_PER_STEP = {"mega_fwd": 1, "mega_dec_loss_bwd": 1, "enc_bwd": 1, "wgrad": 7}
"""Config 4 as it ships (encoder="conv", "mega"): plain torch convs on the
image branch, the tower megakernel on the trajectory branch."""


def _conv_pallas(cfg):
    """``cfg`` with its conv image tower on the conv kernels."""
    import dataclasses

    img = dataclasses.replace(cfg.modalities[0], encoder="conv_pallas")
    return dataclasses.replace(cfg, modalities=[img, *cfg.modalities[1:]])


def _conv_model(seed):
    from vae_assoc_tpu_torch.configs import default_image_arch
    from vae_assoc_tpu_torch.models.conv import ConvVAE

    return ConvVAE(default_image_arch(), device="cuda",
                   generator=torch.Generator().manual_seed(seed))


def _conv_w2d(m, name):
    cin, _, cout = CONV_LAYERS[name][:3]
    net = m.gener if name.startswith("convt") else m.recog
    return net[name].w.detach().reshape(9 * cin, cout)


@torch.no_grad()
def check_conv_kernels(rng, batches=TRAIN_BATCHES):
    """Phase 6c; returns {(kernel, case, batch, dtype): max_abs_err}."""
    from vae_assoc_tpu_torch.kernels import conv as kconv
    from vae_assoc_tpu_torch.kernels import conv_mega as kcm
    from vae_assoc_tpu_torch.kernels import mlp as kmlp

    errs, failed = {}, []
    record = _recorder(errs, failed)
    m = _conv_model(4)
    flat = [t.detach() for t in kcm.flatten(m)]

    def t(*shape, lo=-1.0):
        return torch.from_numpy(rng.uniform(lo, 1.0, shape).astype(np.float32)).cuda()

    for cd, tol in TOL.items():
        line = {}
        for b in batches:
            for name, (cin, h, cout, s, dil, pads, oh) in CONV_LAYERS.items():
                w2d = _conv_w2d(m, name)
                x, dy = t(b, h, h, cin), t(b, oh, oh, cout)
                got = kconv.conv_fwd(x, w2d, s, dil, pads, oh, compute_dtype=cd)
                want = kconv.conv_im2col_plain(x, w2d, s, dil, pads, oh, cd)
                gdx = kconv.conv_dx(dy, w2d, cin, s, dil, pads, h, compute_dtype=cd)
                wdx = kconv.conv_im2col_plain(dy, kconv.flip_w2d(w2d, cin, cout),
                                              *kconv.DX_GEOMETRY[(s, dil, pads)], h, cd)
                gdw = kconv.conv_dw(x, dy, s, dil, pads, oh, compute_dtype=cd)
                wdw = kconv.conv_dw_plain(x, dy, s, dil, pads, oh, cd)
                again = (kconv.conv_fwd(x, w2d, s, dil, pads, oh, compute_dtype=cd),
                         kconv.conv_dx(dy, w2d, cin, s, dil, pads, h, compute_dtype=cd),
                         kconv.conv_dw(x, dy, s, dil, pads, oh, compute_dtype=cd))
                torch.cuda.synchronize()
                if not (torch.equal(got, again[0]) and torch.equal(gdx, again[1])):
                    failed.append(f"conv_fwd {name} B={b} {cd}: two calls differ")
                if not torch.equal(gdw, again[2]):
                    failed.append(f"conv_dw {name} B={b} {cd}: two calls differ")
                for key, pairs in ((("conv_fwd", name, b, cd), [("y", got, want, False)]),
                                   (("conv_fwd", f"{name} dx", b, cd), [("dx", gdx, wdx, False)]),
                                   (("conv_dw", name, b, cd), [("dw", gdw, wdw, True)])):
                    line.setdefault(key[:2], []).append(record(key, pairs, tol))
            x3 = t(b, 28, 28, lo=0.0)
            got = kcm.conv_enc(flat[:10], x3, compute_dtype=cd)
            want = kcm.conv_enc_plain(flat[:10], x3, compute_dtype=cd)
            again = kcm.conv_enc(flat[:10], x3, compute_dtype=cd)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                failed.append(f"conv_enc B={b} {cd}: two calls differ")
            line.setdefault(("conv_enc", "image"), []).append(record(
                ("conv_enc", "image", b, cd),
                [(n, g, w, False) for n, g, w in zip(("mu", "lv", "a1", "a2", "h"), got, want)],
                tol))
            z = t(b, 20)
            for kind in LOSS_KINDS:
                got = kcm.conv_dec(flat[10:], z, x3, kind=kind, compute_dtype=cd)
                want = kcm.conv_dec_plain(flat[10:], z, x3, kind=kind, compute_dtype=cd)
                again = kcm.conv_dec(flat[10:], z, x3, kind=kind, compute_dtype=cd)
                torch.cuda.synchronize()
                if not all(torch.equal(g, a) for g, a in zip(got, again)):
                    failed.append(f"conv_dec {kind} B={b} {cd}: two calls differ")
                line.setdefault(("conv_dec", kind), []).append(record(
                    ("conv_dec", kind, b, cd),
                    [(n, g, w, False) for n, g, w in zip(("rec", "g1", "g2", "d1p", "r"),
                                                         got, want)], tol))
        for (k, case), v in line.items():
            print(f"check {k} {case} {cd} (tol {tol}): " + " ".join(
                f"B={b}:{e:.2e}" for b, e in zip(batches, v)), flush=True)
    n_sm = kmlp.sm_count(torch.device("cuda", 0))
    print("conv_enc rows per block (fp32 and bf16 shared memory in bytes): " + ", ".join(
        f"B={b}: {kcm.enc_plan(b, n_sm)[0]} ({kcm.enc_plan(b, n_sm)[1]}, "
        f"{kcm.enc_plan(b, n_sm, 'bfloat16')[1]})" for b in batches), flush=True)
    if failed:
        raise AssertionError("conv kernel disagrees with its plain twin: "
                             + "; ".join(failed[:20]))
    return errs


def _verbs(p, img, traj, z):
    """Every serving verb of a config-4 Predictor on one batch."""
    outs = {f"transform[{i}]": o for i, o in enumerate(p.transform([img, traj]))}
    outs.update({
        "generate_image": p.generate(z, "image"),
        "generate_trajectory": p.generate(z, "trajectory"),
        "reconstruct_image": p.reconstruct(img, "image"),
        "image_to_trajectory": p.cross_generate(img, "image", "trajectory"),
        "trajectory_to_image": p.cross_generate(traj, "trajectory", "image"),
    })
    return outs


def serve_conv_and_check(rng, card):
    """Phase 4b: config 4 served with encoder="conv_pallas", a Predictor on
    the kernels against the same weights on the plain path (encoder="conv",
    no kernels); returns the launch counts of the kernel predictor's
    requests."""
    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.models.assoc import init_assoc
    from vae_assoc_tpu_torch.serve import Predictor

    cfg, tc = baseline_config(4)
    kcfg = _conv_pallas(cfg)
    model = init_assoc(0, kcfg, device="cuda")
    print(f"serving: baseline config 4 with encoder='conv_pallas', "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"compute_dtype={tc.compute_dtype}", flush=True)
    pred = Predictor(model, kcfg, device="cuda", compute_dtype=tc.compute_dtype, use_pallas=True)
    plain = Predictor(model, cfg, device="cuda", compute_dtype=tc.compute_dtype, use_pallas=False)
    pred.warmup(buckets=(1, 64))
    batches = {}
    for b in (1, 5, 64, 300, 1024):
        batches[b] = (rng.uniform(0, 1, (b, 784)).astype(np.float32),
                      rng.normal(size=(b, 200)).astype(np.float32),
                      rng.normal(size=(b, 20)).astype(np.float32))
    reset_launches()
    got = {b: _verbs(pred, *args) for b, args in batches.items()}
    launches = launch_counts()
    print(f"launches during the conv_pallas predictor's requests: {launches}", flush=True)
    for k in ("conv_fwd", "enc_fwd", "dec_fwd"):
        assert launches[k] > 0, f"kernel {k} was not launched by config 4's serving path"
    tol = TOL[pred.compute_dtype]
    worst, n = 0.0, 0
    for b, args in batches.items():
        want = _verbs(plain, *args)
        for name, w in want.items():
            g = got[b][name]
            assert g.shape == w.shape and np.isfinite(g).all(), (name, b, g.shape, w.shape)
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"{name} B={b}")
            worst, n = max(worst, float(np.abs(g - w).max())), n + 1
        for name in ("generate_image", "reconstruct_image", "trajectory_to_image"):
            assert got[b][name].min() >= 0.0 and got[b][name].max() <= 1.0, name
    print(f"config 4 conv_pallas predictor vs plain path: {n} outputs at B = "
          f"{', '.join(map(str, batches))} agree, max abs err {worst:.3e} (rtol=atol={tol})",
          flush=True)
    time_serving(pred, plain, rng, card, buckets=(1, 64, 256, 1024))
    return launches


def train_conv_and_check(card):
    """Phase 7c: config 4 on the card from one seed (so one ε). Returns the
    launch counts of the conv_pallas mega path's 200 steps."""
    import dataclasses

    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.data.synthetic import generate_raw_strokes
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.models import assoc as assoc_mod
    from vae_assoc_tpu_torch.train import init_train_state, train_loop

    cfg, tc = baseline_config(4)
    kcfg = _conv_pallas(cfg)
    print(f"training: baseline config 4, batch {tc.batch_size}, compute_dtype="
          f"{tc.compute_dtype}, as shipped (encoder='conv', use_pallas={tc.use_pallas!r}) "
          "and with encoder='conv_pallas' on every path", flush=True)
    batch = list(PairedDataset.from_synthetic(tc.batch_size, seed=0, device="cuda").features())
    model = assoc_mod.init_assoc(0, cfg, device="cuda")
    params = list(model.parameters())
    names = [key for key, _ in model.named_parameters()]
    for cd, tol in TOL.items():
        total, _ = assoc_mod.assoc_loss_fn(model, batch, cfg, seed=123, compute_dtype=cd,
                                           use_pallas=False)
        want, want_total = torch.autograd.grad(total, params), float(total.detach())
        for name, up in PATHS.items():
            total, _ = assoc_mod.assoc_loss_fn(model, batch, kcfg, seed=123, compute_dtype=cd,
                                               use_pallas=up)
            got = torch.autograd.grad(total, params)
            worst, bad = _grads_close(names, got, want, tol)
            rel = abs(float(total.detach()) - want_total) / abs(want_total)
            print(f"config 4 {cd} step 0, conv_pallas {name} path vs plain: total "
                  f"{float(total.detach()):.4f} vs {want_total:.4f} (rel {rel:.3e}); "
                  f"{len(params)} grads, max abs err {worst:.3e} (rtol {tol}, atol {tol} x "
                  "max|want|)", flush=True)
            assert rel <= tol and not bad, f"config 4 step 0, {name}: " + "; ".join(bad)

    def run(c, t, steps, per_step):
        state = init_train_state(c, t, device="cuda")
        reset_launches()
        state, h = train_loop(c, t, batch, epochs=steps, state=state)
        launches = launch_counts()
        want = {k: per_step.get(k, 0) * state.step for k in launches}
        assert state.step == steps and launches == want, f"launch counts {launches} != {want}"
        return np.array([e["total"] for e in h]), launches, [e["samples_per_sec"] for e in h]

    one = dataclasses.replace(tc, steps_per_call=1)
    plain, _, rate = run(cfg, dataclasses.replace(one, use_pallas=False), 20, {})
    print("config 4, per-step total, plain path: " + " ".join(f"{v:.4f}" for v in plain),
          flush=True)
    print(f"config 4 plain path: {float(np.median(rate[1:])):.1f} samples/s (train_loop, "
          f"median of steps 2-20, batch {tc.batch_size} fp32) [{card}]", flush=True)
    runs = {f"conv_pallas {n}": (kcfg, up, CONV_PER_STEP[n]) for n, up in PATHS.items()}
    runs["as shipped (conv, mega)"] = (cfg, "mega", SHIPPED_PER_STEP)
    main = None
    for label, (c, up, per_step) in runs.items():
        curve, launches, _ = run(c, dataclasses.replace(one, use_pallas=up), 200, per_step)
        rel = float(np.max(np.abs(curve[:20] - plain) / np.abs(plain)))
        print(f"config 4 {label}: 200 steps with exactly {per_step} launches per step; "
              f"20-step curve vs plain: max rel err {rel:.3e} (rtol 1e-3); total "
              f"{curve[0]:.4f} at step 1, {curve[-1]:.4f} at step 200", flush=True)
        assert np.isfinite(curve).all() and rel <= 1e-3, f"{label}: loss curves disagree"
        assert curve[-1] < curve[0], f"{label}: the loss did not fall over 200 steps"
        if label == "conv_pallas mega":
            main = launches
    return main


def check_conv_plain_bits(card):
    """Phase 7c: config 4 as it ships (plain convs on the image tower under
    "mega") and on the plain path, 5 train_loop steps from two copies of
    one init_train_state in this process: identical bits in every
    parameter and in every step's total."""
    from vae_assoc_tpu_torch.tools.time_checkouts import conv_plain_bits

    t0 = time.perf_counter()
    for path, (same, first, second) in conv_plain_bits(steps=5).items():
        print(f"config 4 {path}: 5 steps twice from one state: identical bits {same}; totals "
              f"{' '.join(repr(v) for v in first)} and {' '.join(repr(v) for v in second)} "
              f"[{card}]", flush=True)
        assert same, f"config 4 {path}: two runs from one state gave other bits"
    print(f"config 4 same-bits check took {time.perf_counter() - t0:.2f} s", flush=True)


ONE_TOWER_PER_STEP = {
    "mega": {"mega_fwd": 1, "mega_dec_loss_bwd": 1, "enc_bwd": 1, "wgrad": 7},
    "composable": {"enc_fwd": 1, "reparam": 1, "dec_fwd": 1, "loss_fwd": 1, "loss_bwd": 1,
                   "dec_bwd": 1, "enc_bwd": 1, "wgrad": 7},
}
"""Hand-written launches per training step of a one-modality model
(baseline configs 1 and 2) on the kernel paths: one tower, the joint loss
kernel at K = 1 on the composable path, 3 + 4 weight-gradient launches."""


def train_one_modality_and_check(card):
    """Phase 7d: baseline configs 1 (image) and 2 (trajectory), one modality
    and λ = 0, at full width from one seed (so one ε) on the mega and
    composable paths against the plain path: step-0 totals and gradients
    within phase 6's tolerances, 200 steps with exactly ONE_TOWER_PER_STEP's
    launches (counts reset just before), the first 20 per-step totals within
    rtol 1e-3 of the plain path's, and the loss falls."""
    import dataclasses

    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.data.synthetic import generate_raw_strokes
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.models import assoc as assoc_mod
    from vae_assoc_tpu_torch.train import init_train_state, train_loop

    for milestone in (1, 2):
        cfg, tc = baseline_config(milestone)
        (mod,) = cfg.modalities
        feats = list(PairedDataset.from_synthetic(tc.batch_size, seed=0, device="cuda").features())
        batch = [feats[("image", "trajectory").index(mod.name)]]
        model = assoc_mod.init_assoc(0, cfg, device="cuda")
        params = list(model.parameters())
        names = [key for key, _ in model.named_parameters()]
        tol = TOL[tc.compute_dtype]
        print(f"training: baseline config {milestone} ({mod.name} only, lambda "
              f"{cfg.assoc_lambda}), {sum(p.numel() for p in params)} parameters, batch "
              f"{tc.batch_size}, compute_dtype={tc.compute_dtype}", flush=True)
        total, _ = assoc_mod.assoc_loss_fn(model, batch, cfg, seed=123,
                                           compute_dtype=tc.compute_dtype, use_pallas=False)
        want, want_total = torch.autograd.grad(total, params), float(total.detach())
        for path in ONE_TOWER_PER_STEP:
            total, _ = assoc_mod.assoc_loss_fn(model, batch, cfg, seed=123,
                                               compute_dtype=tc.compute_dtype,
                                               use_pallas=PATHS[path])
            got = torch.autograd.grad(total, params)
            worst, bad = _grads_close(names, got, want, tol)
            rel = abs(float(total.detach()) - want_total) / abs(want_total)
            print(f"config {milestone} step 0, {path} path vs plain: total "
                  f"{float(total.detach()):.4f} vs {want_total:.4f} (rel {rel:.3e}); "
                  f"{len(params)} grads, max abs err {worst:.3e} (rtol {tol}, atol {tol} x "
                  "max|want|)", flush=True)
            assert rel <= tol and not bad, f"config {milestone} step 0, {path}: " + "; ".join(bad)

        def run(up, steps, per_step):
            t = dataclasses.replace(tc, use_pallas=up, steps_per_call=1)
            state = init_train_state(cfg, t, device="cuda")
            reset_launches()
            state, h = train_loop(cfg, t, batch, epochs=steps, state=state)
            launches = launch_counts()
            want = {k: per_step.get(k, 0) * state.step for k in launches}
            assert state.step == steps and launches == want, f"launch counts {launches} != {want}"
            return np.array([e["total"] for e in h])

        plain = run(False, 20, {})
        for path, per_step in ONE_TOWER_PER_STEP.items():
            curve = run(PATHS[path], 200, per_step)
            rel = float(np.max(np.abs(curve[:20] - plain) / np.abs(plain)))
            print(f"config {milestone} {path} path: 200 steps with exactly {per_step} launches "
                  f"per step; 20-step curve vs plain: max rel err {rel:.3e} (rtol 1e-3); total "
                  f"{curve[0]:.4f} at step 1, {curve[-1]:.4f} at step 200", flush=True)
            assert np.isfinite(curve).all() and rel <= 1e-3, f"config {milestone} {path}: curves"
            assert curve[-1] < curve[0], f"config {milestone} {path}: the loss did not fall"


def time_conv_training(card):
    """Phase 8d: train_loop_fused samples/s on config 4, the four paths in
    turns with plain first and last."""
    import dataclasses

    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.train import train_loop_fused

    cfg, tc = baseline_config(4)
    kcfg = _conv_pallas(cfg)
    data = list(PairedDataset.from_synthetic(16384, seed=2, device="cuda").features())
    paths = {"plain": (cfg, False), "conv mega": (cfg, "mega"),
             "conv_pallas mega": (kcfg, "mega"), "conv_pallas composable": (kcfg, True)}
    order = list(paths) + list(paths)[::-1]
    rates = {}
    for label, kw, rows in (("batch 64 fp32", dict(batch_size=64, compute_dtype="float32"), 4096),
                            ("batch 2048 bf16",
                             dict(batch_size=2048, compute_dtype="bfloat16"), 16384)):
        part = [d[:rows] for d in data]
        tcs = {n: (c, dataclasses.replace(tc, use_pallas=up, **kw)) for n, (c, up) in paths.items()}
        for c, t in tcs.values():
            train_loop_fused(c, t, part, epochs=1, device="cuda")
        runs = {n: [] for n in paths}
        for n in order:
            c, t = tcs[n]
            _, h = train_loop_fused(c, t, part, epochs=1, device="cuda")
            assert np.isfinite(h[-1]["total"])
            runs[n].append(h[0]["samples_per_sec"])
        rates[label] = runs
        print(f"train_loop_fused config 4 {label}: " + "; ".join(
            f"{n} {' '.join(f'{v:.1f}' for v in r)} samples/s" for n, r in runs.items())
            + f" [{card}]", flush=True)
    return rates


def _conv_use(m, name, use, b, t):
    """(x, w2d, stride, dilate, pads, out_hw) of conv_fwd in one use on a
    layer: the layer's forward, or its input gradient (dy, the flipped
    weight and the mapped geometry, as kernels/conv.py::conv_dx)."""
    from vae_assoc_tpu_torch.kernels import conv as kconv

    cin, h, cout, s, dil, pads, oh = CONV_LAYERS[name]
    w2d = _conv_w2d(m, name)
    if use == "fwd":
        return t(b, h, h, cin), w2d, s, dil, pads, oh
    return (t(b, oh, oh, cout), kconv.flip_w2d(w2d, cin, cout),
            *kconv.DX_GEOMETRY[(s, dil, pads)], h)


def _conv_library(m, name, use, x, cd):
    """One cuDNN call that computes conv_fwd's function in this use, on NCHW
    copies of the input and the layer's HWIO weight w in the compute dtype
    (made here, not timed), and the map of its result to NHWC fp32:
    F.conv2d on the input padded (0, 1) for the stride-2 mode (the conv's
    forward; the transposed conv's dx, with w flipped in both spatial axes
    as [cin, cout, 3, 3]); F.conv_transpose2d with that flipped weight,
    cropped to 2h, for the transposed conv's forward; conv2d_input on the
    (0, 1)-padded input's shape, cropped to h, for the conv's dx."""
    import torch.nn.functional as F

    cin, h, *_ = CONV_LAYERS[name]
    dt = torch.bfloat16 if cd == "bfloat16" else torch.float32
    w = (m.gener if name.startswith("convt") else m.recog)[name].w.detach()
    xn = x.permute(0, 3, 1, 2).to(dt).contiguous()
    flipped = w.flip(0, 1).permute(2, 3, 0, 1).to(dt).contiguous()
    if name.startswith("conv") and not name.startswith("convt") and use == "fwd":
        xp, wo = F.pad(xn, (0, 1, 0, 1)), w.permute(3, 2, 0, 1).to(dt).contiguous()
        return (lambda: F.conv2d(xp, wo, stride=2)), lambda r: r.permute(0, 2, 3, 1).float()
    if use == "dx" and name.startswith("convt"):
        xp = F.pad(xn, (0, 1, 0, 1))
        return (lambda: F.conv2d(xp, flipped, stride=2)), lambda r: r.permute(0, 2, 3, 1).float()
    if use == "fwd":
        out = 2 * h
        return (lambda: F.conv_transpose2d(xn, flipped, stride=2),
                lambda r: r[:, :, :out, :out].permute(0, 2, 3, 1).float())
    wo = w.permute(3, 2, 0, 1).to(dt).contiguous()
    shape = (x.shape[0], cin, h + 1, h + 1)
    return (lambda: torch.nn.grad.conv2d_input(shape, wo, xn, stride=2),
            lambda r: r[:, :, :h, :h].permute(0, 2, 3, 1).float())


def _time_case(label, fns, card, bound=None, n=5):
    """{"call": CUDA-event ms per call, "device": profiler busy ms per call}
    of each function in ``fns`` (kernel, plain, and where given the library
    call or other variants of the kernel): two warm-up rounds, then plain,
    kernel, kernel, plain and each other function twice, ``n`` calls each."""
    for _ in range(2):
        for fn in fns.values():
            fn()
    runs = {which: [] for which in fns}
    for which in ("plain", "kernel", "kernel", "plain"):
        runs[which].append(_device_ms(fns[which], n=n))
    for which in fns.keys() - {"kernel", "plain"}:
        runs[which] += [_device_ms(fns[which], n=n) for _ in range(2)]
    call = {which: float(np.mean(r)) for which, r in runs.items()}
    busy = {which: _profiled_ms(fn, n=n) for which, fn in fns.items()}
    if isinstance(bound, dict):  # a bound per function
        tail = "; bound " + ", ".join(f"{w} {t:.4f} ({by})" for w, (t, by) in bound.items())
    else:
        tail = "" if bound is None else f"; bound {bound[0]:.4f} ({bound[1]})"
    print(f"time {label}, ms per call (CUDA events) / device busy per call (profiler): "
          + ", ".join(f"{which} {call[which]:.4f} / {_fmt(busy[which])}" for which in fns)
          + f"{tail} [{card}]", flush=True)
    return {"call": call, "device": busy}


def _dw_library(name, x, dy, cd):
    """One cuDNN call that computes conv_dw's function on a layer, on NCHW
    copies of x and dy in the compute dtype (made here, not timed), and the
    map of its result to [9·cin, cout] fp32: conv2d_weight on the input
    padded (0, 1) for the stride-2 convs; for the transposed convs the same
    call with the roles of input and output gradient swapped (the transposed
    conv is the adjoint of a stride-2 conv with the flipped weight): dy
    padded (0, 1) as the input, x as the output gradient, the result
    flipped back."""
    cin, _, cout, _, dil, *_ = CONV_LAYERS[name]
    dt = torch.bfloat16 if cd == "bfloat16" else torch.float32
    xn = x.permute(0, 3, 1, 2).to(dt).contiguous()
    dyn = dy.permute(0, 3, 1, 2).to(dt).contiguous()
    pad = torch.nn.functional.pad
    if not dil:
        xp = pad(xn, (0, 1, 0, 1))
        return (lambda: torch.nn.grad.conv2d_weight(xp, (cout, cin, 3, 3), dyn, stride=2),
                lambda g: g.permute(2, 3, 1, 0).reshape(9 * cin, cout).float())
    dp = pad(dyn, (0, 1, 0, 1))
    return (lambda: torch.nn.grad.conv2d_weight(dp, (cin, cout, 3, 3), xn, stride=2),
            lambda g: g.permute(2, 3, 0, 1).flip(0, 1).reshape(9 * cin, cout).float())


def time_conv_kernels(rng, card):
    """Phase 8d: device ms per call of the conv kernels at B = 1024 and
    16384, fp32 and bf16: conv_fwd in each of its eight uses (the four
    layers' forward and input gradient) and conv_dw on each layer, each
    against its twin and one cuDNN call checked to compute the same
    function in fp32 (_conv_library, _dw_library; conv_dw's fp32 calls
    with TF32 off, so that cuDNN sums in fp32 as the kernel does);
    conv_enc and conv_dec against their twins."""
    from vae_assoc_tpu_torch.kernels import conv as kconv
    from vae_assoc_tpu_torch.kernels import conv_mega as kcm

    m = _conv_model(5)
    flat = [t.detach() for t in kcm.flatten(m)]
    times = {}

    def t(*shape, lo=-1.0):
        return torch.from_numpy(rng.uniform(lo, 1.0, shape).astype(np.float32)).cuda()

    tf32 = torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        for b in TRAIN_TIMED:
            for cd in TOL:
                for name in CONV_LAYERS:
                    for use in ("fwd", "dx"):
                        x, w2d, s, dil, pads, oh = _conv_use(m, name, use, b, t)
                        library, to_nhwc = _conv_library(m, name, use, x, cd)
                        fns = {"kernel": lambda: kconv.conv_fwd(x, w2d, s, dil, pads, oh,
                                                                compute_dtype=cd),
                               "plain": lambda: kconv.conv_im2col_plain(x, w2d, s, dil, pads,
                                                                        oh, cd),
                               "library": library}
                        if cd == "float32":
                            assert _close(to_nhwc(library()), fns["kernel"](), 1e-4)[1], \
                                f"the library call of conv_fwd {name} {use} is another function"
                        times[("conv_fwd", name, use, b, cd)] = _time_case(
                            f"conv_fwd {name} {use} B={b} {cd}", fns, card,
                            _bound(*_conv_work(b, name), cd))
                torch.backends.cudnn.allow_tf32 = False
                try:
                    for name, (cin, h, cout, s, dil, pads, oh) in CONV_LAYERS.items():
                        x, dy = t(b, h, h, cin), t(b, oh, oh, cout)
                        library, to_dw = _dw_library(name, x, dy, cd)
                        fns = {"kernel": lambda: kconv.conv_dw(x, dy, s, dil, pads, oh,
                                                               compute_dtype=cd),
                               "plain": lambda: kconv.conv_dw_plain(x, dy, s, dil, pads, oh, cd),
                               "library": library}
                        if cd == "float32":
                            assert _close(to_dw(library()), fns["kernel"](), 1e-4,
                                          summed=True)[1], \
                                f"the library call of conv_dw {name} is another function"
                        times[("conv_dw", name, b, cd)] = _time_case(
                            f"conv_dw {name} B={b} {cd}", fns, card,
                            _bound(*_conv_work(b, name), cd))
                finally:
                    torch.backends.cudnn.allow_tf32 = tf32
            x3, z = t(b, 28, 28, lo=0.0), t(b, 20)
            for cd in TOL:
                times[("conv_enc", b, cd)] = _time_case(
                    f"conv_enc B={b} {cd}",
                    {"kernel": lambda: kcm.conv_enc(flat[:10], x3, compute_dtype=cd),
                     "plain": lambda: kcm.conv_enc_plain(flat[:10], x3, compute_dtype=cd)},
                    card, _bound(*_conv_enc_work(b), cd))
                times[("conv_dec", b, cd)] = _time_case(
                    f"conv_dec B={b} {cd}",
                    {"kernel": lambda: kcm.conv_dec(flat[10:], z, x3, kind="bernoulli",
                                                    compute_dtype=cd),
                     "plain": lambda: kcm.conv_dec_plain(flat[10:], z, x3, kind="bernoulli",
                                                         compute_dtype=cd)}, card,
                    _bound(*_conv_dec_work(b), cd))
    return times


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200, (path, r.status)
        return json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        assert r.status == 200, (path, r.status)
        return json.loads(r.read())


def serve_and_check(rng):
    """Phase 4; returns (launch counts of the main path, kernel predictor,
    plain predictor)."""
    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.kernels import LAUNCHES, reset_launches
    from vae_assoc_tpu_torch.models.assoc import init_assoc
    from vae_assoc_tpu_torch.serve import Predictor
    from vae_assoc_tpu_torch.serve_http import ModelServer

    cfg, tc = baseline_config(3)
    model = init_assoc(0, cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serving: baseline config 3, {n_params} parameters, "
          f"compute_dtype={tc.compute_dtype}", flush=True)
    pred = Predictor(model, cfg, device="cuda", compute_dtype=tc.compute_dtype,
                     use_pallas=True)
    plain = Predictor(model, cfg, device="cuda", compute_dtype=tc.compute_dtype,
                      use_pallas=False)
    t0 = time.perf_counter()
    server = ModelServer(pred, max_wait_ms=20.0)
    print(f"ModelServer warmup: {time.perf_counter() - t0:.2f} s", flush=True)
    imgs = rng.uniform(0, 1, (5, 784)).astype(np.float32)
    trajs = rng.normal(size=(5, 200)).astype(np.float32)
    z = rng.normal(size=(5, 20)).astype(np.float32)
    singles = [rng.uniform(0, 1, (1 + i % 3, 784)).astype(np.float32)
               for i in range(16)]
    try:
        base = f"http://127.0.0.1:{server.start(port=0)}"
        reset_launches()
        health = _get(base, "/healthz")
        got = {
            "transform": _post(base, "/v1/transform",
                               {"inputs": [imgs.tolist(), trajs.tolist()]})["latents"],
            "generate_image": _post(base, "/v1/generate",
                                    {"latents": z.tolist(), "modality": "image"})["outputs"],
            "generate_trajectory": _post(base, "/v1/generate",
                                         {"latents": z.tolist(),
                                          "modality": "trajectory"})["outputs"],
            "reconstruct_image": _post(base, "/v1/reconstruct",
                                       {"inputs": imgs.tolist(),
                                        "modality": "image"})["outputs"],
            "image_to_trajectory": _post(base, "/v1/cross_generate",
                                         {"inputs": imgs.tolist(), "src": "image",
                                          "dst": "trajectory"})["outputs"],
            "trajectory_to_image": _post(base, "/v1/cross_generate",
                                         {"inputs": trajs.tolist(),
                                          "src": "trajectory", "dst": "image"})["outputs"],
        }
        with ThreadPoolExecutor(max_workers=16) as ex:
            conc = list(ex.map(
                lambda x: _post(base, "/v1/cross_generate",
                                {"inputs": x.tolist(), "src": "image",
                                 "dst": "trajectory"})["outputs"],
                singles,
            ))
        statz = _get(base, "/statz")
        launches = dict(LAUNCHES)
    finally:
        server.close()
    print(f"healthz: {health}", flush=True)
    print(f"statz after 16 concurrent + 3 batched requests: {statz}", flush=True)
    print(f"launches during the requests: {launches}", flush=True)
    assert health["status"] == "ok" and health["modalities"] == ["image", "trajectory"]
    for name in ("enc_fwd", "dec_fwd"):  # config 3 has no conv tower: conv_fwd stays 0
        assert launches[name] > 0, f"kernel {name} was not launched by the serving path"

    tol = TOL[pred.compute_dtype]
    want = {
        "transform": plain.transform([imgs, trajs]),
        "generate_image": plain.generate(z, "image"),
        "generate_trajectory": plain.generate(z, "trajectory"),
        "reconstruct_image": plain.reconstruct(imgs, "image"),
        "image_to_trajectory": plain.cross_generate(imgs, "image", "trajectory"),
        "trajectory_to_image": plain.cross_generate(trajs, "trajectory", "image"),
    }
    shapes = {
        "generate_image": (5, 784), "generate_trajectory": (5, 200),
        "reconstruct_image": (5, 784), "image_to_trajectory": (5, 200),
        "trajectory_to_image": (5, 784),
    }
    pairs = [(f"transform[{i}]", np.asarray(g, np.float32), w)
             for i, (g, w) in enumerate(zip(got["transform"], want["transform"]))]
    pairs += [(k, np.asarray(got[k], np.float32), want[k]) for k in shapes]
    pairs += [(f"concurrent[{i}]", np.asarray(c, np.float32),
               plain.cross_generate(x, "image", "trajectory"))
              for i, (c, x) in enumerate(zip(conc, singles))]
    for name, g, w in pairs:
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
    for name, shape in shapes.items():
        assert np.asarray(got[name]).shape == shape, name
    for name in ("generate_image", "reconstruct_image", "trajectory_to_image"):
        g = np.asarray(got[name])
        assert g.min() >= 0.0 and g.max() <= 1.0, f"{name} leaves [0, 1]"
    worst = max(float(np.abs(g - w).max()) for _, g, w in pairs)
    print(f"HTTP routes vs plain path: {len(pairs)} outputs agree, max abs err "
          f"{worst:.3e} (rtol=atol={tol})", flush=True)
    return launches, pred, plain


def _pcts(fn, n):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def time_serving(pred, plain, rng, card, buckets=BUCKETS):
    """Phase 5a: host-clock latency of Predictor.cross_generate (each call
    ends in a device-to-host copy, so it waits for the device)."""
    for b in buckets:
        x = rng.uniform(0, 1, (b, 784)).astype(np.float32)
        for p in (pred, plain):
            for _ in range(3):
                p.cross_generate(x, "image", "trajectory")
        samples = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            p = pred if name == "kernel" else plain
            samples[name] += _pcts(lambda: p.cross_generate(x, "image", "trajectory"), 25)
        k, q = np.array(samples["kernel"]), np.array(samples["plain"])
        print(f"latency {pred.cfg.modalities[0].encoder} image tower, cross_generate "
              f"image->trajectory bucket={b}: kernel "
              f"p50={np.percentile(k, 50):.4f} p95={np.percentile(k, 95):.4f} ms; "
              f"plain p50={np.percentile(q, 50):.4f} p95={np.percentile(q, 95):.4f} ms "
              f"[{card}]", flush=True)


def _device_ms(fn, n=50):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_kernels(model, cd, rng, card):
    """Phase 5b: device time per launch of each config-3 tower, kernel
    against plain twin, in turns (plain, kernel, kernel, plain), at the
    serving buckets and at the training batch 16384 in the served dtype
    ``cd``, and in bf16 at B = 1024 and 16384; {(tower, batch, dtype):
    (kernel ms, plain ms)}."""
    from vae_assoc_tpu_torch.kernels import mlp as kmlp

    img, traj = model.modalities
    stacks = {
        "image_enc": (kmlp.encode_mlp_fused, kmlp.encode_mlp_plain, img, 784, (IMAGE_ENC, 2)),
        "trajectory_enc": (kmlp.encode_mlp_fused, kmlp.encode_mlp_plain, traj, 200,
                           ((200, 500, 500, 20), 2)),
        "image_dec": (kmlp.decode_mlp_fused, kmlp.decode_mlp_plain, img, 20, (IMAGE_DEC, 1)),
        "trajectory_dec": (kmlp.decode_mlp_fused, kmlp.decode_mlp_plain, traj, 20,
                           (TRAJ_DEC, 1)),
    }
    times = {}
    settings = [(b, cd) for b in BUCKETS + TRAIN_TIMED[-1:]]
    settings += [(b, "bfloat16") for b in TRAIN_TIMED if cd != "bfloat16"]
    with torch.inference_mode():
        for b, cd in settings:
            for name, (fused, plain, m, width, shape) in stacks.items():
                x = torch.from_numpy(rng.uniform(0, 1, (b, width)).astype(np.float32)).cuda()
                runs = {"kernel": [], "plain": []}
                for _ in range(3):
                    fused(m, x, compute_dtype=cd)
                    plain(m, x, compute_dtype=cd)
                for which in ("plain", "kernel", "kernel", "plain"):
                    fn = fused if which == "kernel" else plain
                    runs[which].append(_device_ms(lambda: fn(m, x, compute_dtype=cd)))
                k, p = float(np.mean(runs["kernel"])), float(np.mean(runs["plain"]))
                times[(name, b, cd)] = (k, p)
                bound = _bound(*_stack_work(b, *shape), cd)
                print(f"device time {name} B={b} {cd}: kernel {k:.4f} ms, plain "
                      f"{p:.4f} ms, plain/kernel {p / k:.3f}; bound {bound[0]:.4f} "
                      f"({bound[1]}) [{card}]", flush=True)
    return times


# Layer widths of the config-3/5 towers (models/networks.py layout).
IMAGE_ENC = (784, 500, 500, 20)  # input, hidden..., head width (μ and logσ² heads)
IMAGE_DEC = (20, 500, 500, 784)
TRAJ_DEC = (20, 500, 500, 200)


def _bound(nbytes, flops, compute_dtype="float32"):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over its peak for their type: bf16 on the
    tensor cores, fp32 without them."""
    peak = BF16_FLOPS_PER_S if compute_dtype == "bfloat16" else FP32_FLOPS_PER_S
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _layers(widths, heads):
    """(n_in, n_out) of every layer of a stack: the hidden layers, then
    ``heads`` output layers of the last width."""
    *body, out = widths
    return list(zip(body[:-1], body[1:])) + [(body[-1], out)] * heads


def _weight_bytes(layers):
    return 4 * sum(i * o + o for i, o in layers)


def _stack_work(b, widths, heads):
    """(bytes, flops) of a forward stack over b rows: input and outputs once,
    every weight once."""
    layers = _layers(widths, heads)
    return (4 * b * (widths[0] + heads * widths[-1]) + _weight_bytes(layers),
            2 * b * sum(i * o for i, o in layers))


def _stack_bwd_work(b, widths, heads, remat_head=False, extra_in=0, dx=True, wgrad=True):
    """(bytes, flops) of a stack backward over b rows: the rematerialized
    forward (hidden layers, and the head where the loss needs it), the
    cotangent chain (on to the input where ``dx``) and, where ``wgrad``,
    every weight grad; reads the input, the head cotangents (or
    ``extra_in`` columns of loss inputs instead) and the weights, writes
    the input gradient where ``dx`` and the weight grads, or without
    ``wgrad`` their per-row operands (each hidden layer's activation and
    cotangent)."""
    layers = _layers(widths, heads)
    macs = sum(i * o for i, o in layers)
    remat = sum(i * o for i, o in (layers if remat_head else layers[:-heads]))
    chain = macs - (0 if dx else layers[0][0] * layers[0][1])
    head_in = extra_in or heads * widths[-1]
    per_row = (1 + dx) * widths[0] + head_in + (0 if wgrad else 2 * sum(widths[1:-1]))
    nbytes = 4 * b * per_row + (1 + wgrad) * _weight_bytes(layers)
    return nbytes, 2 * b * (remat + chain + (macs if wgrad else 0))


def _mega_fwd_work(b):
    """(bytes, flops) of the image tower's forward with injected ε: x and ε
    read, μ, logσ², ε, recon and kl written, both nets' weights once."""
    enc, dec = _layers(IMAGE_ENC, 2), _layers(IMAGE_DEC, 1)
    macs = sum(i * o for i, o in enc + dec)
    return (4 * b * (784 + 20 + 3 * 20 + 2) + _weight_bytes(enc) + _weight_bytes(dec),
            2 * b * macs)


def _reparam_work(b, n_z=20):
    """(bytes, flops): μ, logσ² read, z, ε written; about 10 float operations
    per element (Box–Muller, the exponential, the product and sum)."""
    return 4 * b * n_z * 4, 10 * b * n_z


def _loss_work(b, bwd, widths=(784, 200), n_z=20):
    """(bytes, flops) of the joint loss with its association column (kinds
    bernoulli + gaussian): the forward reads x, r, μ, logσ² and writes
    [B, 5]; the backward reads those and the [B, 5] cotangent and writes
    drecon, dμ, dlogσ². Flops: about 8 per Bernoulli element, 3 per
    Gaussian one, 6 per KL element, 3 per association element (forward),
    or 4, 3, 7 and 3 (backward)."""
    inputs = 2 * sum(widths) + 4 * n_z
    if bwd:
        nbytes = 4 * b * (5 + inputs + sum(widths) + 2 * 2 * n_z)
        flops = b * (4 * widths[0] + 3 * widths[1] + 2 * 7 * n_z + 2 * 3 * n_z)
    else:
        nbytes = 4 * b * (inputs + 5)
        flops = b * (8 * widths[0] + 3 * widths[1] + 2 * 6 * n_z + 3 * n_z)
    return nbytes, flops


def _wgrad_work(b, m=500, n=784):
    """(bytes, flops) of dW = AᵀD and db over b rows: A [b, m] and D [b, n]
    read, dW and db written."""
    return 4 * (b * (m + n) + (m + 1) * n), 2 * b * m * n


def _conv_macs(name):
    """Useful multiply-adds per image of one conv layer: 9 taps × cin × cout
    per pixel of its undilated side (the stride-2 conv's output, the
    transposed conv's input), so the zeros of a dilated input do not count."""
    cin, h, cout, stride, _, _, oh = CONV_LAYERS[name]
    return 9 * cin * cout * (oh * oh if stride == 2 else h * h)


def _conv_work(b, name):
    """(bytes, flops) of conv_fwd on a layer (x and the weight read, y
    written), and of conv_dw (x and dy read, dw written: the same sizes)."""
    cin, h, cout, _, _, _, oh = CONV_LAYERS[name]
    return 4 * (b * (h * h * cin + oh * oh * cout) + 9 * cin * cout), 2 * b * _conv_macs(name)


def _conv_enc_work(b, hr=500, n_z=20):
    """(bytes, flops) of conv_enc: x read; μ, logσ², a1, a2, h written; the
    weights once."""
    weights = 9 * 32 + 32 + 9 * 32 * 64 + 64 + 3136 * hr + hr + 2 * (hr * n_z + n_z)
    macs = _conv_macs("conv1") + _conv_macs("conv2") + 3136 * hr + 2 * hr * n_z
    return 4 * (b * (784 + 2 * n_z + 6272 + 3136 + hr) + weights), 2 * b * macs


def _conv_dec_work(b, hg=500, n_z=20):
    """(bytes, flops) of conv_dec: z and x read; recon, g1, g2, d1p and the
    logits written; the weights once."""
    weights = n_z * hg + hg + hg * 3136 + 3136 + 9 * 64 * 32 + 32 + 9 * 32 + 1
    macs = n_z * hg + hg * 3136 + _conv_macs("convt1") + _conv_macs("convt2")
    return 4 * (b * (n_z + 784 + 1 + hg + 3136 + 6272 + 784) + weights), 2 * b * macs


# Phase 9's resume in a fresh process: load each saved model and fit the
# saved batch once; print each cost's repr.
RESUME_CHILD = """
import sys, torch
from vae_assoc_tpu_torch import AssocVariationalAutoEncoder
batch = torch.load(sys.argv[1], map_location="cuda")
for sub in sys.argv[2:]:
    print(repr(AssocVariationalAutoEncoder.load(sub).partial_fit(batch)))
"""

EVAL_ROWS = 4096  # phase 9's synthetic pairs; MLL decodes 8 × 4096 rows a block
MLL_ROWS = 8 * EVAL_ROWS
EVAL_KERNELS = {  # what each eval function must launch on each kernel setting
    "evaluate": ("enc_fwd", "dec_fwd"),
    "eval_metrics": ("enc_fwd", "dec_fwd"),
    "recognition_accuracy": ("enc_fwd",),
    "marginal_log_likelihood": ("enc_fwd", "dec_fwd"),
}
EVAL_LOSS_KERNELS = {"mega": ("mega_fwd",), True: ("reparam", "loss_fwd")}
FIT_KERNELS = {"mega": ("mega_fwd", "mega_dec_loss_bwd", "enc_bwd", "wgrad"),
               True: ("enc_fwd", "reparam", "dec_fwd", "loss_fwd", "loss_bwd", "dec_bwd",
                      "enc_bwd", "wgrad")}


def _eval_keys(cfg, mll: bool):
    """The keys of the JAX package's vae-assoc-eval output for ``cfg``."""
    names = [m.name for m in cfg.modalities]
    keys = {"model_dir", "step", "data", "n_samples", "backend", "total", "assoc"}
    keys |= {f"{t}_{n}" for n in names for t in ("recon", "kl")}
    for a in names:
        keys |= {f"mse_{a}->{b}" for b in names}
        keys |= {f"knn_{a}" if a == b else f"knn_{a}->{b}" for b in names}
    if mll:
        keys |= {f"{t}_{n}" for n in names for t in ("elbo", "iwae")}
    return keys


def check_mll_decode(model, rng, card):
    """Phase 9's dec_fwd at the MLL's row count against its twin, fp32 and
    bf16, twice for identical bits, and timed (CUDA events, in turns)."""
    from vae_assoc_tpu_torch.kernels import mlp as kmlp

    errs, failed = {}, []
    with torch.inference_mode():
        for name, m, shape in (("image_dec", model.modalities[0], IMAGE_DEC),
                               ("trajectory_dec", model.modalities[1], TRAJ_DEC)):
            z = torch.from_numpy(rng.normal(size=(MLL_ROWS, 20)).astype(np.float32)).cuda()
            for cd, tol in TOL.items():
                got = kmlp.decode_mlp_fused(m, z, compute_dtype=cd)
                again = kmlp.decode_mlp_fused(m, z, compute_dtype=cd)
                want = kmlp.decode_mlp_plain(m, z, compute_dtype=cd)
                torch.cuda.synchronize()
                err, ok = _max_err(got, want, tol)
                errs[(name, MLL_ROWS, cd)] = err
                if not ok or not torch.equal(got, again):
                    failed.append(f"{name} B={MLL_ROWS} {cd} err={err:.3e}")
                runs = {"kernel": [], "plain": []}
                for which in ("plain", "kernel", "kernel", "plain"):
                    fn = kmlp.decode_mlp_fused if which == "kernel" else kmlp.decode_mlp_plain
                    runs[which].append(_device_ms(lambda: fn(m, z, compute_dtype=cd), n=10))
                k, p = float(np.mean(runs["kernel"])), float(np.mean(runs["plain"]))
                bound = _bound(*_stack_work(MLL_ROWS, shape, heads=1), cd)
                print(f"check {name} dec_fwd B={MLL_ROWS} {cd} (rtol=atol={tol}): err "
                      f"{err:.2e}; device time kernel {k:.4f} ms, plain {p:.4f} ms; bound "
                      f"{bound[0]:.4f} ({bound[1]}) [{card}]", flush=True)
    if failed:
        raise AssertionError("dec_fwd at the MLL's rows disagrees: " + "; ".join(failed))
    return errs


def api_and_eval_check(rng, card):
    """Phase 9: the class API, whole-state checkpoints, every reload path,
    evaluation and the evaluate CLI on config 3 at full width. Returns the
    launches of each eval function on each kernel setting."""
    import dataclasses
    import tempfile

    from vae_assoc_tpu_torch import AssocVariationalAutoEncoder
    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.data.synthetic import generate_raw_strokes
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.serve import Predictor
    from vae_assoc_tpu_torch.train import eval as ev

    cfg, tc = baseline_config(3)
    tol = TOL["float32"]
    t_phase = t0 = time.perf_counter()
    ds = PairedDataset.from_synthetic(EVAL_ROWS, seed=0, device="cuda")
    imgs, trajs = ds.features()
    labels = np.asarray(ds.labels)
    print(f"phase 9: {EVAL_ROWS} synthetic pairs featurized on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # The digests tell runs' data apart: the strokes are drawn on the host,
    # the pairs featurized on the card, where the same strokes must give the
    # same bits (exact resume across runs rests on it).
    again = PairedDataset.from_synthetic(EVAL_ROWS, seed=0, device="cuda").features()
    assert all(torch.equal(a, b) for a, b in zip(again, (imgs, trajs))), \
        "featurizing the same strokes twice gave other bits"
    strokes = generate_raw_strokes(EVAL_ROWS, seed=0)["points"]
    pairs = torch.cat([imgs, trajs], 1).cpu().numpy()
    print(f"phase 9: sha256 of the strokes {_digest(strokes)}, of the pairs "
          f"{_digest(pairs)} (featurized twice, identical)", flush=True)

    # Train: 30 partial_fit steps at batch 64 on each path from seed 0.
    models, costs, fit_launches = {}, {}, {}
    for up in ("mega", True, False):
        t = dataclasses.replace(tc, use_pallas=up, batch_size=64)
        models[up] = m = AssocVariationalAutoEncoder([], model_config=cfg, train_config=t)
        reset_launches()
        t0 = time.perf_counter()
        costs[up] = np.array([m.partial_fit([imgs[i * 64:(i + 1) * 64],
                                             trajs[i * 64:(i + 1) * 64]]) for i in range(30)])
        dt = time.perf_counter() - t0
        fit_launches[up] = launch_counts()
        print(f"partial_fit use_pallas={up!r}: {30 / dt:.1f} steps/s at batch 64 fp32; cost "
              f"{costs[up][0]:.4f} -> {costs[up][-1]:.4f} [{card}]", flush=True)
        for k in FIT_KERNELS.get(up, ()):
            assert fit_launches[up][k] > 0, f"partial_fit on {up!r} launched no {k}"
        if up is False:
            assert not any(fit_launches[up].values()), f"plain path launched {fit_launches[up]}"
    print(f"partial_fit launches over 30 steps: mega {fit_launches['mega']}, composable "
          f"{fit_launches[True]}", flush=True)
    for up in ("mega", True):
        rel = float(np.max(np.abs(costs[up] - costs[False]) / np.abs(costs[False])))
        print(f"partial_fit costs, use_pallas={up!r} vs plain: max rel err {rel:.3e} "
              "(rtol 1e-3)", flush=True)
        assert np.isfinite(costs[up]).all() and rel <= 1e-3, "partial_fit costs disagree"
        assert costs[up][-5:].mean() < costs[up][:5].mean(), "the cost did not fall"

    m = models["mega"]
    x_img, x_traj = imgs[:1024], trajs[:1024]
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        # Exact resume: save, fit, restore, fit: identical bits, in this
        # process and in a fresh one that loads the saved directory.
        batch = [imgs[2048:2112], trajs[2048:2112]]
        torch.save(batch, os.path.join(d, "batch.pt"))
        firsts = {}
        for up in ("mega", True):
            sub = os.path.join(d, str(up))
            models[up].save_model(sub)
            firsts[up] = first = models[up].partial_fit(batch)
            models[up].restore_model(sub)
            again = models[up].partial_fit(batch)
            print(f"exact resume use_pallas={up!r}: {first!r} then {again!r}", flush=True)
            assert first == again, "save -> fit -> restore -> fit gave another cost"
            models[up].restore_model(sub)
        out = subprocess.run(
            [sys.executable, "-c", RESUME_CHILD, os.path.join(d, "batch.pt")]
            + [os.path.join(d, str(up)) for up in firsts],
            cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True,
            text=True, timeout=300,
        )
        assert out.returncode == 0, out.stderr[-3000:]
        for (up, first), line in zip(firsts.items(), out.stdout.split()):
            print(f"exact resume use_pallas={up!r} in a fresh process: {float(line)!r}",
                  flush=True)
            assert float(line) == first, "a fresh process resumed to another cost"
        path = os.path.join(d, "mega")
        step = m.state.step

        # Reload and serve: every path gives the live model's outputs.
        x_np = {0: x_img.cpu().numpy(), 1: x_traj.cpu().numpy()}
        live = {(0, 1): m.cross_generate(x_img, 0, 1), (1, 0): m.cross_generate(x_traj, 1, 0)}
        kw = dict(compute_dtype=tc.compute_dtype, use_pallas="mega")
        snap = Predictor.from_model(m, **kw)
        reloads = {
            "AssocVariationalAutoEncoder.load": AssocVariationalAutoEncoder.load(path),
            "Predictor.load(step=)": Predictor.load(path, step=step),
            "Predictor.from_checkpoint": Predictor.from_checkpoint(
                path, cfg, train_config=m.train_config, **kw),
            "Predictor.from_model": snap,
        }
        for name, r in reloads.items():
            for (s, t), want in live.items():
                got = torch.as_tensor(r.cross_generate(x_np[s], s, t), device="cuda")
                err, ok = _close(got, want, tol)
                print(f"reload {name} {s}->{t}: max abs err {err:.3e} vs the live model "
                      f"(rtol=atol={tol}), bit-identical {torch.equal(got, want)}", flush=True)
                assert ok, f"{name} disagrees with the live model"
        before = snap.cross_generate(x_np[0], 0, 1)
        m.partial_fit([imgs[:64], trajs[:64]])
        assert np.array_equal(snap.cross_generate(x_np[0], 0, 1), before), \
            "a from_model predictor changed with partial_fit"
        assert not torch.equal(m.cross_generate(x_img, 0, 1), live[(0, 1)])
        m.restore_model(path)

        # Evaluate the saved weights on the three settings from one seed.
        xs = [imgs, trajs]
        results, eval_launches, secs = {}, {}, {}
        for up in ("mega", True, False):
            params = AssocVariationalAutoEncoder.load(path).state.params
            calls = {
                "evaluate": lambda: ev.evaluate(params, xs, cfg, use_pallas=up),
                "eval_metrics": lambda: ev.eval_metrics(params, xs, cfg, use_pallas=up),
                "recognition_accuracy": lambda: ev.recognition_accuracy(
                    params, xs, labels, cfg, use_pallas=up),
                "marginal_log_likelihood": lambda: ev.marginal_log_likelihood(
                    params, xs, cfg, n_importance=64, max_samples=EVAL_ROWS, use_pallas=up),
            }
            res = {}
            for fname, call in calls.items():
                call()  # warm
                reset_launches()
                t0 = time.perf_counter()
                out = call()
                torch.cuda.synchronize()
                secs[(fname, up)] = time.perf_counter() - t0
                counts = launch_counts()
                eval_launches[(fname, up)] = {k: v for k, v in counts.items() if v}
                want = EVAL_KERNELS[fname] + (EVAL_LOSS_KERNELS.get(up, ())
                                              if fname == "eval_metrics" else ())
                if up is False:
                    assert not any(counts.values()), f"plain {fname} launched {counts}"
                for k in want if up is not False else ():
                    assert counts[k] > 0, f"{fname} on {up!r} launched no {k}"
                res.update(out)
            results[up] = res
            print(f"eval use_pallas={up!r}: " + ", ".join(
                f"{f} {secs[(f, up)]:.3f} s" for f in calls) + f" (wall) [{card}]",
                flush=True)
            print(f"eval use_pallas={up!r} launches: "
                  + "; ".join(f"{f} {eval_launches[(f, up)]}" for f in calls), flush=True)
        for up in ("mega", True):
            for key, want in results[False].items():
                got = results[up][key]
                slack = 0.01 if key.startswith("knn_") else tol + tol * abs(want)
                assert np.isfinite(got) and abs(got - want) <= slack, \
                    f"eval {key} on {up!r}: {got} vs plain {want}"
        print("eval, plain: " + json.dumps(results[False]), flush=True)
        print(f"eval: MSE, loss terms, ELBO and IWAE of mega and composable agree with plain "
              f"(rtol=atol={tol}), k-NN within 0.01", flush=True)
        for name in ("image", "trajectory"):
            for up in results:
                assert results[up][f"iwae_{name}"] >= results[up][f"elbo_{name}"]

        # The CLI as a user runs it.
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "vae_assoc_tpu_torch.evaluate", path, "--data",
             "synthetic", "--n-samples", str(EVAL_ROWS), "--mll-samples", "64"],
            cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True,
            text=True, timeout=300,
        )
        dt = time.perf_counter() - t0
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        missing = _eval_keys(cfg, mll=True) - set(res)
        assert not missing, f"the evaluate CLI's output lacks {sorted(missing)}"
        assert res["backend"] == "cuda" and res["step"] == step
        bad = [k for k, v in res.items() if isinstance(v, float) and not np.isfinite(v)]
        assert not bad, f"the evaluate CLI gave non-finite {bad}"
        print(f"evaluate CLI: exit 0 in {dt:.2f} s wall, {len(res)} keys [{card}]", flush=True)
        print("evaluate CLI: " + json.dumps(res), flush=True)
    print(f"phase 9 took {time.perf_counter() - t_phase:.2f} s wall", flush=True)
    return eval_launches


UJI_FIXTURE = "tests/fixtures/ujipenchars2_format.txt"
UJI_EPOCHS = 40  # 3 batches of 64 an epoch from the fixture's 240 characters
MEGA_PER_STEP = {"mega_fwd": 2, "mega_dec_loss_bwd": 2, "enc_bwd": 2, "wgrad": 14}
"""Hand-written launches per training step of config 3 on the mega path:
two towers, 3 + 4 weight-gradient launches each."""
STREAM_ROWS, STREAM_BATCH = 65536, 16384


def _uji_train(cfg, tc, ds, state, seed, epochs=UJI_EPOCHS):
    """train_loop on ``ds``'s features from a copy of ``state``, with a
    refresh_data hook that featurizes an augmented view each epoch from a
    generator seeded with ``seed``. Returns (state, per-epoch totals,
    wall seconds)."""
    import copy

    from vae_assoc_tpu_torch.ops.augment import AugmentConfig
    from vae_assoc_tpu_torch.train import train_loop

    gen = torch.Generator(device="cuda").manual_seed(seed)
    aug = AugmentConfig()
    t0 = time.perf_counter()
    state, h = train_loop(cfg, tc, ds.features(), epochs=epochs, state=copy.deepcopy(state),
                          refresh_data=lambda e: ds.features(augment=aug, generator=gen))
    torch.cuda.synchronize()
    return state, np.array([e["total"] for e in h]), time.perf_counter() - t0


def _same_state(a, b) -> bool:
    return a.step == b.step and all(
        torch.equal(p, q) for p, q in zip(a.params.parameters(), b.params.parameters()))


def data_surface_check(card):
    """Phase 10: the UJI fixture on the card, from the native parse to
    `evaluate --data uji`, and the streamed input. Returns the kernels'
    launches in the mega training run and the in-process evaluations."""
    import copy
    import dataclasses
    import tempfile

    from vae_assoc_tpu_torch import AssocVariationalAutoEncoder, native
    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset, stream_train
    from vae_assoc_tpu_torch.data.uji import load_uji_files
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.ops.augment import AugmentConfig
    from vae_assoc_tpu_torch.ops.rbf import rbf_reconstruct
    from vae_assoc_tpu_torch.train import (eval as ev, eval_params, init_train_state,
                                           make_train_step, train_loop_fused)

    here = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(here, UJI_FIXTURE)
    tol = TOL["float32"]
    t_phase = t0 = time.perf_counter()

    # 1. Parse: the native parser (built here with g++) against the Python one.
    lib = native.build()
    t_build = time.perf_counter() - t0
    parsed = {}
    for mode in ("always", "never"):
        t0 = time.perf_counter()
        parsed[mode] = load_uji_files([fixture], native=mode)
        print(f"phase 10: parsed the UJI fixture with native={mode!r} in "
              f"{time.perf_counter() - t0:.4f} s", flush=True)
    nat, py = parsed["always"], parsed["never"]
    for k in ("points", "lengths", "labels"):
        assert nat[k].dtype == py[k].dtype and np.array_equal(nat[k], py[k]), \
            f"the native parse's {k} differ from the Python parse's"
    assert nat["label_names"] == py["label_names"]
    n = len(nat["labels"])
    print(f"phase 10: native parser {lib.name} built in {t_build:.2f} s; {n} characters, "
          f"native = Python bit for bit (points {_digest(nat['points'])})", flush=True)

    # 2. Featurize on the card, twice each, and against the CPU.
    cpu = {}
    feats = {}
    for enc in ("resample", "rbf"):
        t0 = time.perf_counter()
        ds = PairedDataset.from_uji([fixture], traj_encoding=enc, device="cuda")
        got = ds.features()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        again = PairedDataset.from_uji([fixture], traj_encoding=enc, device="cuda").features()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{enc}: other bits"
        views = [ds.features(augment=AugmentConfig(),
                             generator=torch.Generator(device="cuda").manual_seed(7))
                 for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*views)), f"{enc} augmented: other bits"
        cpu[enc] = PairedDataset.from_uji([fixture], traj_encoding=enc, device="cpu").features()
        err_img, ok_img = _close(got[0].cpu(), cpu[enc][0], tol)
        if enc == "rbf":  # the weights of an fp32 solve differ; the curves must not
            got_c, want_c = rbf_reconstruct(got[1], 100).cpu(), rbf_reconstruct(cpu[enc][1], 100)
        else:
            got_c, want_c = got[1].cpu(), cpu[enc][1]
        err_traj, ok_traj = _close(got_c, want_c, tol)
        print(f"phase 10: {enc} features {tuple(got[0].shape)} {tuple(got[1].shape)} in "
              f"{dt:.3f} s, twice identical, augmented view twice identical; sha256 "
              f"{_digest(torch.cat(got, 1).cpu().numpy())}, augmented "
              f"{_digest(torch.cat(views[0], 1).cpu().numpy())}; vs the CPU: images "
              f"{err_img:.2e}, trajectories {err_traj:.2e} (rtol=atol={tol})", flush=True)
        assert ok_img and ok_traj, f"{enc}: the card's features disagree with the CPU's"
        feats[enc] = ds

    # 3. Train config 3 on the UJI features, a fresh augmented view each epoch.
    cfg, tc = baseline_config(3)
    tc = dataclasses.replace(tc, use_pallas="mega", batch_size=64, compute_dtype="float32",
                             steps_per_call=1)
    ds = feats["resample"]
    state0 = init_train_state(cfg, tc, device="cuda")
    reset_launches()
    mega, curve, dt = _uji_train(cfg, tc, ds, state0, seed=11)
    launches = launch_counts()
    steps = UJI_EPOCHS * (n // tc.batch_size)
    want = {k: MEGA_PER_STEP.get(k, 0) * steps for k in launches}
    assert mega.step == steps and launches == want, f"launch counts {launches} != {want}"
    again, curve2, _ = _uji_train(cfg, tc, ds, state0, seed=11)
    assert _same_state(mega, again) and np.array_equal(curve, curve2), \
        "two runs with refresh_data from one state and seed gave other bits"
    assert np.isfinite(curve).all() and curve[-5:].mean() < curve[:5].mean(), "no learning"
    _, plain, _ = _uji_train(cfg, dataclasses.replace(tc, use_pallas=False), ds, state0, seed=11)
    rel = float(np.max(np.abs(curve - plain) / np.abs(plain)))
    print(f"phase 10: config 3 mega on the UJI fixture, {UJI_EPOCHS} epochs x "
          f"{n // tc.batch_size} steps with refresh_data: {steps / dt:.1f} steps/s incl. "
          f"augmenting (wall); total {curve[0]:.4f} -> {curve[-1]:.4f}, twice identical "
          f"bits; vs plain max rel err {rel:.3e} (rtol 1e-3); launches {launches} "
          f"[{card}]", flush=True)
    assert rel <= 1e-3, "the mega and plain per-epoch totals disagree"

    # 4. Save and evaluate per encoding: in process and through the CLI.
    eval_launches = {}
    states = {"resample": mega}
    rbf_ds = feats["rbf"]
    states["rbf"], rbf_curve, _ = _uji_train(cfg, tc, rbf_ds, state0, seed=12, epochs=10)
    assert np.isfinite(rbf_curve).all() and rbf_curve[-1] < rbf_curve[0]
    with tempfile.TemporaryDirectory() as d:
        for enc, st in states.items():
            sub = os.path.join(d, enc)
            model = AssocVariationalAutoEncoder([], model_config=cfg, train_config=tc)
            model.state = st
            model.save_model(sub)
            with open(os.path.join(sub, "model_config.json")) as f:
                raw = json.load(f)
            raw["data"] = {"source": "uji", "traj_encoding": enc, "rbf_centers": 100}
            with open(os.path.join(sub, "model_config.json"), "w") as f:
                json.dump(raw, f, indent=1)

            xs = list(feats[enc].features())
            labels = np.asarray(feats[enc].labels)
            params = eval_params(tc, st)
            ekw = dict(compute_dtype=tc.compute_dtype, use_pallas=tc.use_pallas)
            reset_launches()
            want = {f"mse_{k}": v for k, v in ev.evaluate(params, xs, cfg, **ekw).items()}
            em = ev.eval_metrics(params, xs, cfg, batch_size=1024, seed=0, **ekw)
            want.update({k: v for k, v in em.items() if "->" not in k})
            want.update(ev.recognition_accuracy(params, xs, labels, cfg, k=5, **ekw))
            want.update(ev.marginal_log_likelihood(params, xs, cfg, n_importance=16, seed=0,
                                                   max_samples=4096, **ekw))
            eval_launches[enc] = launch_counts()
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "vae_assoc_tpu_torch.evaluate", sub, "--data", "uji",
                 "--uji-paths", fixture, "--mll-samples", "16"],
                cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True,
                text=True, timeout=300,
            )
            cli_s = time.perf_counter() - t0
            assert out.returncode == 0, out.stderr[-3000:]
            res = json.loads(out.stdout.strip().splitlines()[-1])
            missing = _eval_keys(cfg, mll=True) - set(res)
            assert not missing, f"the evaluate CLI's output lacks {sorted(missing)}"
            assert (res["data"], res["n_samples"], res["backend"]) == ("uji", n, "cuda")
            for key, w in want.items():
                slack = 0.01 if key.startswith("knn_") else tol + tol * abs(w)
                assert np.isfinite(res[key]) and abs(res[key] - w) <= slack, \
                    f"evaluate --data uji ({enc}) {key}: {res[key]} vs in process {w}"
            other = "resample" if enc == "rbf" else "rbf"
            bad = subprocess.run(
                [sys.executable, "-m", "vae_assoc_tpu_torch.evaluate", sub, "--data", "uji",
                 "--uji-paths", fixture, "--traj-encoding", other],
                cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True,
                text=True, timeout=300,
            )
            assert bad.returncode != 0 and "contradicts" in bad.stderr, bad.stderr[-2000:]
            print(f"phase 10: evaluate --data uji ({enc}): exit 0 in {cli_s:.2f} s wall, "
                  f"{len(res)} keys, each within rtol=atol={tol} of train/eval.py in process "
                  f"(k-NN 0.01); --traj-encoding {other} exits {bad.returncode} [{card}]",
                  flush=True)
            print(f"phase 10: evaluate --data uji ({enc}): " + json.dumps(res), flush=True)

    # 5. The streamed input against a synchronous loop over the same slices.
    big = dataclasses.replace(tc, batch_size=STREAM_BATCH, compute_dtype="bfloat16")
    data = [x.cpu().numpy() for x in
            PairedDataset.from_synthetic(STREAM_ROWS, seed=3, device="cuda").features()]
    step_fn = make_train_step(cfg, big)
    start = init_train_state(cfg, big, device="cuda")
    streamed, hist = stream_train(step_fn, copy.deepcopy(start), data, STREAM_BATCH, seed=5)
    sync = copy.deepcopy(start)
    order = np.random.default_rng(5).permutation(STREAM_ROWS)
    for b in range(STREAM_ROWS // STREAM_BATCH):
        sel = order[b * STREAM_BATCH:(b + 1) * STREAM_BATCH]
        sync, _ = step_fn(sync, [torch.from_numpy(x[sel]).to("cuda") for x in data])
    assert _same_state(streamed, sync), "stream_train's state differs from the synchronous loop's"
    t0 = time.perf_counter()
    stream_train(step_fn, copy.deepcopy(start), data, STREAM_BATCH, seed=6)
    stream_rate = STREAM_ROWS / (time.perf_counter() - t0)
    dev_data = [torch.from_numpy(x).cuda() for x in data]
    train_loop_fused(cfg, big, dev_data, epochs=1, device="cuda")
    _, h = train_loop_fused(cfg, big, dev_data, epochs=1, device="cuda")
    print(f"phase 10: stream_train over {STREAM_ROWS} pairs at batch {STREAM_BATCH} bf16 mega, "
          f"1 epoch: the synchronous loop's bits; {stream_rate:.1f} samples/s, "
          f"train_loop_fused {h[0]['samples_per_sec']:.1f} samples/s [{card}]", flush=True)
    print(f"phase 10 took {time.perf_counter() - t_phase:.2f} s wall", flush=True)
    total = dict(launches)
    for c in eval_launches.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vae_assoc_tpu_torch.kernels import _build

    # Phase 1
    card = _card()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)

    # Phase 2
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    print((lib_path.parent / "build.log").read_text().strip(), flush=True)

    # Phase 3
    rng = np.random.default_rng(0)
    errs = check_kernels(rng)

    # Phase 4
    launches, pred, plain = serve_and_check(rng)
    # Phase 4b
    serve_conv_and_check(rng, card)

    # Phase 5
    time_serving(pred, plain, rng, card)
    times = time_kernels(pred.params, pred.compute_dtype, rng, card)

    # Phase 6
    train_errs = check_train_kernels(rng)
    # Phase 6b
    train_errs.update(check_composable_kernels(rng))
    # Phase 6c
    train_errs.update(check_conv_kernels(rng))

    # Phase 7
    train_launches = train_and_check(card)
    # Phase 7b
    composable_launches = train_composable_and_check(card)
    # Phase 7c
    conv_launches = train_conv_and_check(card)
    check_conv_plain_bits(card)
    # Phase 7d
    train_one_modality_and_check(card)

    # Phase 8
    time_training(card)
    train_times = time_train_kernels(rng, card)
    # Phase 8d
    time_conv_training(card)
    train_times.update(time_conv_kernels(rng, card))

    # Phase 9
    eval_launches = api_and_eval_check(rng, card)
    errs.update(check_mll_decode(pred.params, rng, card))

    # Phase 10
    uji_launches = data_surface_check(card)

    cd = pred.compute_dtype
    big, small = TRAIN_TIMED[-1], TRAIN_TIMED[0]
    # (name, source, TPU kernel, launch counts, max_abs_err key, times, bound)
    rows = [
        ("enc_fwd", SOURCE, "vae_assoc_tpu/kernels/mlp.py:299", launches,
         ("image_enc", TIMED_BATCH, cd), times[("image_enc", TIMED_BATCH, cd)],
         _bound(*_stack_work(TIMED_BATCH, IMAGE_ENC, heads=2))),
        ("dec_fwd", SOURCE, "vae_assoc_tpu/kernels/mlp.py:486", launches,
         ("trajectory_dec", TIMED_BATCH, cd), times[("trajectory_dec", TIMED_BATCH, cd)],
         _bound(*_stack_work(TIMED_BATCH, TRAJ_DEC, heads=1))),
        ("mega_fwd", CSRC + "mega.cu", "vae_assoc_tpu/kernels/megakernel.py:192",
         train_launches, ("mega_fwd", "image", big, "float32"),
         train_times[("mega_fwd", big, "float32")], _bound(*_mega_fwd_work(big))),
        ("mega_dec_loss_bwd", CSRC + "mega.cu", "vae_assoc_tpu/kernels/megakernel.py:240",
         train_launches, ("mega_dec_loss_bwd", "image", big, "float32"),
         train_times[("mega_dec_loss_bwd", big, "float32")],
         _bound(*_stack_bwd_work(big, IMAGE_DEC, heads=1, remat_head=True, extra_in=785))),
        ("enc_bwd", CSRC + "mlp_bwd.cu", "vae_assoc_tpu/kernels/mlp.py:309",
         train_launches, ("enc_bwd", "image", big, "float32"),
         train_times[("enc_bwd", big, "float32")],
         _bound(*_stack_bwd_work(big, IMAGE_ENC, heads=2))),
        ("wgrad", CSRC + "mlp_bwd.cu", "vae_assoc_tpu/kernels/mlp.py:285",
         train_launches, ("wgrad", "image", big, "float32"),
         train_times[("wgrad", big, "float32")], _bound(*_wgrad_work(big))),
        ("dec_bwd", CSRC + "mlp_bwd.cu", "vae_assoc_tpu/kernels/mlp.py:495",
         composable_launches, ("dec_bwd", "image", small, "float32"),
         train_times[("dec_bwd", small, "float32")],
         _bound(*_stack_bwd_work(small, IMAGE_DEC, heads=1))),
        ("reparam", CSRC + "sampling.cu", "vae_assoc_tpu/kernels/sampling.py:67",
         composable_launches, ("reparam", "n_z=20", small, "float32"),
         train_times[("reparam", small, "float32")], _bound(*_reparam_work(small))),
        ("loss_fwd", CSRC + "loss.cu", "vae_assoc_tpu/kernels/loss.py:36",
         composable_launches, ("loss_fwd", "assoc=True", small, "float32"),
         train_times[("loss_fwd", small, "float32")], _bound(*_loss_work(small, bwd=False))),
        ("loss_bwd", CSRC + "loss.cu", "vae_assoc_tpu/kernels/loss.py:69",
         composable_launches, ("loss_bwd", "assoc=True", small, "float32"),
         train_times[("loss_bwd", small, "float32")], _bound(*_loss_work(small, bwd=True))),
        ("conv_fwd", CSRC + "conv.cu",
         "vae_assoc_tpu/kernels/conv.py:103, vae_assoc_tpu/kernels/conv_banded.py:125",
         conv_launches, ("conv_fwd", "conv2", big, "float32"),
         train_times[("conv_fwd", "conv2", "fwd", big, "float32")],
         _bound(*_conv_work(big, "conv2"))),
        ("conv_dw", CSRC + "conv.cu", "vae_assoc_tpu/kernels/conv.py:125", conv_launches,
         ("conv_dw", "conv2", big, "float32"), train_times[("conv_dw", "conv2", big, "float32")],
         _bound(*_conv_work(big, "conv2"))),
        ("conv_enc", CSRC + "conv_mega.cu", "vae_assoc_tpu/kernels/conv_mega.py:189",
         conv_launches, ("conv_enc", "image", big, "float32"),
         train_times[("conv_enc", big, "float32")], _bound(*_conv_enc_work(big))),
        ("conv_dec", CSRC + "conv_mega.cu", "vae_assoc_tpu/kernels/conv_mega.py:209",
         conv_launches, ("conv_dec", "bernoulli", big, "float32"),
         train_times[("conv_dec", big, "float32")], _bound(*_conv_dec_work(big))),
    ]
    # The kernels this record also gives in bf16: (times, bound, error key).
    dec_bwd_work = _stack_bwd_work(big, IMAGE_DEC, heads=1, remat_head=True, extra_in=785)
    bf16 = {
        "enc_fwd": (times[("image_enc", TIMED_BATCH, "bfloat16")],
                    _bound(*_stack_work(TIMED_BATCH, IMAGE_ENC, heads=2), "bfloat16"),
                    ("image_enc", TIMED_BATCH, "bfloat16")),
        "dec_fwd": (times[("trajectory_dec", TIMED_BATCH, "bfloat16")],
                    _bound(*_stack_work(TIMED_BATCH, TRAJ_DEC, heads=1), "bfloat16"),
                    ("trajectory_dec", TIMED_BATCH, "bfloat16")),
        "mega_fwd": (train_times[("mega_fwd", big, "bfloat16")],
                     _bound(*_mega_fwd_work(big), "bfloat16"),
                     ("mega_fwd", "image", big, "bfloat16")),
        "mega_dec_loss_bwd": (train_times[("mega_dec_loss_bwd", big, "bfloat16")],
                              _bound(*dec_bwd_work, "bfloat16"),
                              ("mega_dec_loss_bwd", "image", big, "bfloat16")),
        "conv_enc": (train_times[("conv_enc", big, "bfloat16")],
                     _bound(*_conv_enc_work(big), "bfloat16"),
                     ("conv_enc", "image", big, "bfloat16")),
        "conv_dw": (train_times[("conv_dw", "conv2", big, "bfloat16")],
                    _bound(*_conv_work(big, "conv2"), "bfloat16"),
                    ("conv_dw", "conv2", big, "bfloat16")),
        "conv_dec": (train_times[("conv_dec", big, "bfloat16")],
                     _bound(*_conv_dec_work(big), "bfloat16"),
                     ("conv_dec", "bernoulli", big, "bfloat16")),
        "wgrad": (train_times[("wgrad", big, "bfloat16")],
                  _bound(*_wgrad_work(big), "bfloat16"), ("wgrad", "image", big, "bfloat16")),
        "conv_fwd": (train_times[("conv_fwd", "conv2", "fwd", big, "bfloat16")],
                     _bound(*_conv_work(big, "conv2"), "bfloat16"),
                     ("conv_fwd", "conv2", big, "bfloat16")),
        "enc_bwd": (train_times[("enc_bwd", big, "bfloat16")],
                    _bound(*_stack_bwd_work(big, IMAGE_ENC, heads=2), "bfloat16"),
                    ("enc_bwd", "image", big, "bfloat16")),
        "dec_bwd": (train_times[("dec_bwd", small, "bfloat16")],
                    _bound(*_stack_bwd_work(small, IMAGE_DEC, heads=1), "bfloat16"),
                    ("dec_bwd", "image", small, "bfloat16")),
    }
    # The stack backward without dx (as the training paths run it): its bound.
    nodx_work = {"enc_bwd": _stack_bwd_work(big, IMAGE_ENC, heads=2, dx=False),
                 "dec_bwd": _stack_bwd_work(small, IMAGE_DEC, heads=1, dx=False)}

    def ms(timed, which):
        """The profiler's device time where it has one, else CUDA events."""
        t = timed["device"].get(which)
        return t if t is not None else timed["call"].get(which)

    def events(timed):
        """Phase 5b's (kernel, plain) CUDA events as a timed case."""
        if isinstance(timed, tuple):
            return {"call": dict(zip(("kernel", "plain"), timed)), "device": {}}
        return timed

    kernels = []
    for name, src, replaces, counts, err_key, timed, (bound_ms, bound_by) in rows:
        errs_of = errs if name in ("enc_fwd", "dec_fwd") else train_errs
        timed = events(timed)
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs_of[err_key],
            "ms": ms(timed, "kernel"), "plain_ms": ms(timed, "plain"), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": ms(timed, "library"),
            # launches by phase 9's evaluation and MLL on both kernel settings
            "eval_launches": sum(c.get(name, 0) for c in eval_launches.values()),
            # launches by phase 10's UJI training and its in-process evaluation
            "uji_launches": uji_launches.get(name, 0),
        }
        if "alone" in timed["call"]:  # the kernel without its weight-gradient launches
            row["alone_ms"] = ms(timed, "alone")
        if name in nodx_work:  # with its weight-gradient launches, without dx
            row["nodx_ms"] = ms(timed, "nodx")
            row["nodx_bound_ms"] = _bound(*nodx_work[name])[0]
        if name in bf16:
            t16, (b16_ms, b16_by), key16 = bf16[name]
            t16 = events(t16)
            row["bf16"] = {"max_abs_err": errs_of[key16], "ms": ms(t16, "kernel"),
                           "plain_ms": ms(t16, "plain"), "bound_ms": b16_ms,
                           "bound_by": b16_by, "library_ms": ms(t16, "library")}
            for which in ("alone", "nodx"):
                if which in t16["call"]:
                    row["bf16"][f"{which}_ms"] = ms(t16, which)
            if name in nodx_work:
                row["bf16"]["nodx_bound_ms"] = _bound(*nodx_work[name], "bfloat16")[0]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
