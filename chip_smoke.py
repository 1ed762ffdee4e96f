#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vae_assoc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only sketch    # phases 1, 2 and 15 alone

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
11. The deploy path: config 3 (phase 4's weights), config 4 with
   encoder="conv_pallas" and config 3 conditional (n_cond=10) at full
   width, each written with save_params and exported by `python -m
   vae_assoc_tpu_torch.export DIR OUT --device cuda` (the three at once);
   a fresh process loads the three artifacts on the card, poisons the
   model modules and serves every endpoint at batches 1, 7, 64, 257, 1024,
   4096 and 5000 (chunked): each output within rtol = atol = 1e-5 of the
   plain Predictor and within phase 4's tolerance of the kernel-path
   Predictor (whose launches, counted from 0, must include enc_fwd,
   dec_fwd and conv_fwd); config 3 exported on the CPU and served on the
   card within 1e-5 of the card-written artifact, launching no kernel;
   `serve_http --from-export --compile-cache DIR` as a subprocess answers
   one POST per route (within 1e-4 of plain) and exits 0 on SIGTERM; phase
   2's library copied into a fresh cache directory serves the kernel path
   in a process with --compile-cache, an empty CUDA_HOME and no nvcc on
   PATH, without a build (start seconds beside phase 2's build seconds).
   Prints the artifact's load and warmup seconds, cross_generate
   image->trajectory p50/p95 of the artifact, the kernel path and plain at
   buckets 1 to 4096, and an empty kernel's launch timed beside the
   sampler at B = 1024 and 16384, as the kernel rows are and queued behind
   a spin kernel.
12. The parallel layouts (vae_assoc_tpu_torch/parallel/) on one NCCL
   process group of world size 1 (a file store in a temp dir; NCCL refuses
   two ranks on one card): DP on config 5 as shipped, 3 steps with
   injected ε equal to train/step.py's _one_step bit for bit (grad_norm
   within 1e-6), dp_train_loop for 2 epochs with exactly
   COMPOSABLE_PER_STEP launches a step, the loss falling, and twice from
   one state to the same bits; ZeRO on config 5, on config 3 "mega" at
   batch 16384 bf16 and on config 4 conv_pallas (batch 64 fp32, conv_fwd
   and conv_dw launched) against DP from one state and seed, bit for bit
   or within rtol 3e-5 / atol 1e-6 (the reason printed); TP on config 3
   with use_pallas=True in fp32 and bf16 at batch 1024, 5 steps with
   exactly TP_PER_STEP launches a step, each step's loss and gradient norm
   within rtol 1e-3 of the single-device composable step's, step 1's
   gradient of every leaf within an error norm of 1e-4 (fp32) or 1e-2
   (bf16) of its norm, and after 5 steps 99.9 % of the weights within
   rtol 1e-3 / atol 1e-5 (Adam turns the two paths' other rounding into
   whole steps on weights whose gradient nearly cancels) with every leaf's
   error norm within 0.25 of its movement, the gather/shard round trip bit
   for bit; two gloo ranks sharing the card on config 3 composable at
   batch 1024 with injected ε: step-1 gradients within rtol 2e-5 / atol
   1e-6 of the world-1 step's on the global batch, 3 steps' losses and
   gradient norms within rtol 2e-5, both ranks' weights equal, ZeRO's
   equal to DP's bit for bit, and every weight within rtol 2e-5 / atol
   1e-6 of the world-1 step's. Prints config 5's samples/s under dp_train_loop beside
   train_loop_fused, DP's, ZeRO's and TP's steps/s, each layout's host
   enqueue and wall ms a step on config 3 at batch 1024 beside the
   single-device step's, an NCCL all-reduce's time at world size 1, and
   the phase's wall seconds.
13. The rest of the parallel layouts, on a second NCCL group of world
   size 1 and on gloo ranks sharing the card, each run 5 steps with
   injected ε: TP under the package's GSPMD names on config 4's conv tower
   (encoder="conv", plain convs, batch 64 fp32) against the single-device
   step, and remat=True on config 3's TP step (composable, batch 1024)
   against remat=False; TP × FSDP on config 5 (batch 1024 bf16,
   composable) on a 1 × 1 ("data", "model") mesh against TP on the same
   mesh from one seed, weights and losses bit for bit with exactly
   TP_PER_STEP launches a step; two gloo ranks: the conv TP (channel
   splits 16/32) against world 1, and the GPipe ring (S = 2, M = 4) on
   config 3 deepened to 5 hidden layers of 500 per net, batch 1024 fp32,
   against the single-device plain step (losses within rel 1e-3, every
   leaf within an error norm of 1e-3 of its norm) and twice to the same
   bits; four gloo ranks: TP × FSDP on a 2 × 2 mesh against world 1. The
   tolerance gates are phase 12's TP ones (losses and gradient norms rel
   1e-3, 99.9 % of the weights within rtol 1e-3 / atol 1e-5, every leaf's
   error norm within 0.25 of its movement). Prints each layout's steps/s,
   samples/s and host enqueue ms a step beside the single-device step's
   (or TP's), a TP × FSDP rank's share of the weights, and the phase's
   wall seconds.
14. The training CLI (python -m vae_assoc_tpu_torch.train.driver), run in
   this process unless said otherwise: config 3 at full width with
   --use-pallas (the composable kernels; config 3 ships on the plain path,
   and no flag of the CLI selects the megakernel) for 2 epochs on 4096
   synthetic pairs with --metrics, --ckpt-dir and --val-frac 0.1: the
   epoch totals finite and falling, the composable kernels launched, the
   JSONL records with the JAX CLI's keys, the checkpoint's
   Predictor.from_checkpoint giving the trained weights' cross_generate
   within phase 4's tolerance, --resume --epochs 3 going on from the saved
   step; the same command in a subprocess with --preempt-chunk 1 getting
   SIGTERM after its first epoch, exiting 0 with a checkpoint, and --resume
   finishing it; config 5 (composable, bf16, batch 1024) and config 4 as
   they ship (config 4: plain convs on the image tower, the tower
   megakernel on the trajectory tower) for 2 epochs each, their kernels
   launched and their totals falling; --sweep-seeds 3 --sweep-lambdas
   0.5 1 2 on config 3 (the plain path), every model's total falling, its
   samples/s a model and in all printed beside 3 standalone train_loop
   runs', and each member's first 5 step losses within rtol 1e-4 of its
   standalone step on the same batches; --dry-compile --config 3 printing
   2,049,064 parameters; two gloo ranks sharing the card running --mesh 2
   --zero on config 5 for one epoch to the same weights; and
   graft_entry.dryrun_multichip(4, backend="gloo"), every leg. Prints the
   CLI's steps/s beside train_loop_fused's and the phase's wall seconds.
   No CLI flag selects the conv kernels (encoder="conv_pallas"), so the
   CLI launches none of them.
15. The sketch tower's kernels at the shapes of the cell
   sk-train-rnn-bf16-b100 (Sketch-RNN's get_default_hparams, batch 100,
   N_max 250): lstm_fwd and lstm_bwd over every step of the encoder's two
   directions (256 units each, lengths uniform on 64..250) and of the
   decoder (512 units, with its per-row addend z·W + b), fp32 and bf16,
   against their plain twins run step by step on the same card from the
   same inputs: the states, the gate pre-activations, the gate gradients
   and the initial state's gradients, each within TOL of its largest value
   (rtol = atol = 1e-4 fp32, 2e-2 bf16). The twin with W_h's input and
   forget gates swapped (a kernel that read the gates in the wrong order)
   must miss that tolerance. mixture_loss against its twin on 25,000 × 123
   head rows (the loss at rtol = atol = 1e-5, the gradient at rtol 1e-4,
   atol 1e-5); the twin with μx and μy swapped must miss it. Each of the
   three timed against its twin, beside its bound. Then the cell's model
   trained through train_loop_fused (composable kernels, bf16) for 4 steps
   at batch 100: the launch counts, reset just before, are 2 lstm_fwd,
   2 lstm_bwd and 1 mixture_loss a step (one persistent launch a layer each
   way), and the losses finite. Before the checks it prints the split each
   layer's kernels take (kernels/lstm.py::step_plan; one launch a layer in
   both precisions) and the step barrier's cost alone (lstm_sync_probe, µs
   a step).

Phases 3 and 6b also check a stack with no hidden layer (the config-3
image decoder's output layer alone, TP's column-split layer), forward
and backward, with identical bits on a second call.

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
10's training and in-process evaluation, "export_launches" by phase 11's
kernel-path Predictors, "parallel_launches" by phases 12 and 13's layouts
at world size 1 (their own runs, not the single-device steps they are
held against; the gloo ranks' launches are their processes'),
"cli_launches" by phase 14's runs of the CLI in this process; the rows of
phase 15's lstm_fwd, lstm_bwd and mixture_loss give the "shape" they were
timed at, their "launches" in its 4-step sketch training run, and for the
LSTM kernels a "bf16" object; reparam also gives "floor_ms", an empty kernel's
launch timed as its row, and "queued_ms" and "floor_queued_ms", the two
queued behind a spin kernel (the device's time a launch, without the
host's pace); enc_bwd and dec_bwd
also give "nodx_ms" and
"nodx_bound_ms", with their weight-gradient launches but without dx. The
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside this file, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import functools
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
    # A stack with no hidden layer, as tensor parallelism runs a column-split
    # output layer: the config-3 image decoder's output layer alone.
    gen = torch.Generator().manual_seed(1)
    dec0 = _Depth0(init_mlp_vae_params(gen, default_image_arch(), device="cuda"))
    for cd, tol in TOL.items():
        line = []
        for b in BATCHES:
            h = torch.from_numpy(rng.normal(size=(b, 500)).astype(np.float32)).cuda()
            got = kmlp.decode_mlp_fused(dec0, h, compute_dtype=cd)
            again = kmlp.decode_mlp_fused(dec0, h, compute_dtype=cd)
            want = kmlp.decode_mlp_plain(dec0, h, compute_dtype=cd)
            failed += _forward_bits(f"depth-0 dec B={b} {cd}", (got,), (again,))
            err, ok = _max_err(got, want, tol)
            errs[("image_out_depth0_dec", b, cd)] = err
            line.append(f"B={b}:{err:.2e}")
            if not ok:
                failed.append(f"depth-0 dec B={b} {cd} err={err:.3e}")
        print(f"check image_out_depth0 dec_fwd {cd} (rtol=atol={tol}): " + " ".join(line),
              flush=True)
    if failed:
        raise AssertionError("kernel disagrees with its plain twin: "
                             + "; ".join(failed))
    return errs


class _Depth0:
    """The output layer of a model's generator as a stack with no hidden
    layer, as decode_mlp_fused reads one (parallel/tp.py's column split)."""

    def __init__(self, m):
        self.gener = {"out": m.gener["out"]}

    def parameters(self):
        return [self.gener["out"].w, self.gener["out"].b]


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
    # The stack with no hidden layer (phase 3's): dz = dout·Wᵀ in the stack
    # backward, the weight grads in wgrad.
    head = init_mlp_vae_params(torch.Generator().manual_seed(3), default_image_arch(),
                               device="cuda").gener["out"]
    for cd, tol in TOL.items():
        line = []
        for b in batches:
            h = torch.from_numpy(rng.normal(size=(b, 500)).astype(np.float32)).cuda()
            dout = torch.from_numpy(rng.normal(size=(b, 784)).astype(np.float32)).cuda() / b
            got = kmlp.decode_bwd([], head, h, dout, compute_dtype=cd)
            want = kmlp.decode_bwd_plain([], head, h, dout, compute_dtype=cd)
            failed += _same_bits(f"dec_bwd depth-0 B={b} {cd}", got,
                                 kmlp.decode_bwd([], head, h, dout, compute_dtype=cd),
                                 kmlp.decode_bwd([], head, h, dout, compute_dtype=cd,
                                                 want_dx=False))
            pairs = [("dz", got[1], want[1], False), ("dw", got[0][0][0], want[0][0][0], True),
                     ("db", got[0][0][1], want[0][0][1], True)]
            line.append(record(("dec_bwd", "image_out_depth0", b, cd), pairs, tol))
        print(f"check image_out_depth0 dec_bwd {cd} (tol {tol}): " + " ".join(
            f"B={b}:{e:.2e}" for b, e in zip(batches, line)), flush=True)
    print("dec_bwd depth-0 " + _stack_plans(kmlp, [], batches,
                                            kmlp.sm_count(torch.device("cuda", 0))),
          flush=True)

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


EXPORT_BATCHES = (1, 7, 64, 257, 1024, 4096, 5000)  # 5000: chunked past MAX_BUCKET
EXPORT_TOL = 1e-5  # the artifact against the plain Predictor: the same aten ops
EXPORT_COND = 10  # phase 11's conditional model, as phase 3's conditional tower

# Phase 11's fresh process: load each artifact on the card, poison the model
# modules, run every endpoint at every batch on the saved requests and save
# the outputs. It imports this file for the batches and the verbs.
EXPORT_CHILD = """
import sys
import numpy as np
from chip_smoke import EXPORT_BATCHES, _export_verbs
from vae_assoc_tpu_torch.export import ExportedPredictor

out, inputs, jobs = sys.argv[1], np.load(sys.argv[2]), sys.argv[3:]
eps = {label: ExportedPredictor.load(art, device="cuda")
       for label, art in zip(jobs[0::2], jobs[1::2])}
for name in list(sys.modules):
    if "vae_assoc_tpu_torch.models" in name or name.endswith(".serve"):
        del sys.modules[name]
sys.modules["vae_assoc_tpu_torch.models"] = None  # an import would raise
sys.modules["vae_assoc_tpu_torch.serve"] = None
res = {}
for label, ep in eps.items():
    img, traj, z = (inputs[f"{label}/{k}"] for k in ("img", "traj", "z"))
    cond = inputs[f"{label}/cond"] if f"{label}/cond" in inputs.files else None
    for b in EXPORT_BATCHES:
        got = _export_verbs(ep, img[:b], traj[:b], z[:b], None if cond is None else cond[:b])
        res.update({f"{label}/{b}/{k}": v for k, v in got.items()})
np.savez(out, **res)
print(f"{len(res)} outputs of {len(eps)} artifacts in a process without model code")
"""


def _export_verbs(p, img, traj, z, cond=None):
    """Every exported endpoint of a Predictor-like object on one batch, by
    endpoint name (phase 11; its fresh process imports this)."""
    ck = {} if cond is None else {"cond": cond}
    xs = [img, traj] + ([] if cond is None else [cond])
    outs = {f"transform[{i}]": o for i, o in enumerate(p.transform(xs))}
    for j in (0, 1):
        outs[f"generate_{j}"] = p.generate(z, j, **ck)
    for i, x in enumerate((img, traj)):
        for j in (0, 1):
            outs[f"cross_generate_{i}_{j}"] = p.cross_generate(x, i, j, **ck)
    return outs


def _serve_http(root, args, env):
    """Start ``python -m vae_assoc_tpu_torch.serve_http *args`` on the card;
    returns (process, base URL, seconds to the bound socket, its lines so
    far). A process that has not bound its socket in 300 s is killed."""
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vae_assoc_tpu_torch.serve_http", *args, "--device", "cuda",
         "--port", "0"], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(300, proc.kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if " on http://" in line:
                break
    finally:
        timer.cancel()
    if not lines or " on http://" not in lines[-1]:
        proc.kill()
        proc.wait()
        raise RuntimeError("serve_http did not bind its socket:\n" + "\n".join(lines[-40:]))
    base = lines[-1].split(" on ", 1)[1].split(" ", 1)[0]
    return proc, base, time.perf_counter() - t0, lines


def _stop(proc):
    """SIGTERM, as an orchestrator stops a server; returns (exit code, output)."""
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return proc.returncode, out


def _http_verbs(base, img, traj, z):
    """One POST per route (both cross_generate directions), and /healthz."""
    assert _get(base, "/healthz")["status"] == "ok"
    post = functools.partial(_post, base)
    return {
        "transform[0]": post("/v1/transform",
                             {"inputs": [img.tolist(), traj.tolist()]})["latents"][0],
        "generate_0": post("/v1/generate", {"latents": z.tolist(),
                                            "modality": "image"})["outputs"],
        "cross_generate_0_0": post("/v1/reconstruct", {"inputs": img.tolist(),
                                                       "modality": "image"})["outputs"],
        "cross_generate_0_1": post("/v1/cross_generate",
                                   {"inputs": img.tolist(), "src": "image",
                                    "dst": "trajectory"})["outputs"],
        "cross_generate_1_0": post("/v1/cross_generate",
                                   {"inputs": traj.tolist(), "src": "trajectory",
                                    "dst": "image"})["outputs"],
    }


def time_export_serving(ep, pred, plain, rng, card, buckets=BUCKETS):
    """Phase 11: host-clock latency of cross_generate image→trajectory on
    the exported artifact, the kernel-path and the plain Predictor, in turns
    (plain, kernel, export, export, kernel, plain), 25 calls each a turn."""
    paths = {"export": ep, "kernel": pred, "plain": plain}
    for b in buckets:
        x = rng.uniform(0, 1, (b, 784)).astype(np.float32)
        for p in paths.values():
            for _ in range(3):
                p.cross_generate(x, "image", "trajectory")
        samples = {name: [] for name in paths}
        for name in ("plain", "kernel", "export", "export", "kernel", "plain"):
            p = paths[name]
            samples[name] += _pcts(lambda: p.cross_generate(x, "image", "trajectory"), 25)
        print(f"latency config 3 cross_generate image->trajectory bucket={b}: " + "; ".join(
            f"{name} p50={np.percentile(s, 50):.4f} p95={np.percentile(s, 95):.4f} ms"
            for name, s in samples.items()) + f" [{card}]", flush=True)


def _queued_ms(fn, n=100):
    """Device ms per call of ``fn`` with ``n`` calls queued behind a spin
    kernel (``torch.cuda._sleep``), so that the device runs them back to
    back and the host's pace, which CUDA events around calls of a few µs
    read instead, does not show. The spin grows until it outlasts the
    host's queueing (the start event still pending when the last call is
    queued)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for cycles in (10**7, 10**8, 10**9):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / n
    raise RuntimeError("the host did not queue the calls before the spin kernel ended")


def time_launch_floor(card):
    """Phase 11: one launch of an empty kernel of the library, timed in the
    same windows and by the same means as the kernel rows (CUDA events around
    10 calls; the profiler's busy time), beside the sampler at B = 1024 and
    16384; and both again queued behind a spin (``_queued_ms``). Returns
    {batch: the timed case, with the queued times under "queued"}."""
    from vae_assoc_tpu_torch.kernels import _build
    from vae_assoc_tpu_torch.kernels import sampling as ksamp

    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        _build.check(lib, lib.vae_empty(stream), "empty kernel launch")

    times = {}
    with torch.no_grad():
        for b in TRAIN_TIMED:
            mu = torch.rand(b, 20, device="cuda")
            lv = torch.rand(b, 20, device="cuda")
            fns = {"kernel": lambda: ksamp.reparameterize_kernel(mu, lv, 5),
                   "plain": lambda: ksamp.reparameterize_plain(mu, lv, 5), "floor": empty}
            times[b] = _time_case(f"reparam beside the launch floor B={b} float32", fns,
                                  card, _bound(*_reparam_work(b)), n=10)
            times[b]["queued"] = {w: _queued_ms(fns[w]) for w in ("kernel", "floor")}
            print(f"time reparam B={b} float32 queued behind a spin, device ms per launch: "
                  f"kernel {times[b]['queued']['kernel']:.4f}, empty kernel "
                  f"{times[b]['queued']['floor']:.4f} [{card}]", flush=True)
    return times


def export_and_check(rng, card, pred, plain, lib_path, build_s):
    """Phase 11: the deploy path. Returns (the kernels' launches by the
    kernel-path Predictors the artifacts are held against, the launch
    floor's timed cases)."""
    import dataclasses
    import shutil
    import tempfile

    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.export import ExportedPredictor, export_predictor
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.models.assoc import init_assoc
    from vae_assoc_tpu_torch.serve import Predictor
    from vae_assoc_tpu_torch.utils.checkpoint import save_params

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    cfg3, tc3 = baseline_config(3)
    cfg4, tc4 = baseline_config(4)
    kcfg4 = _conv_pallas(cfg4)
    ccfg = dataclasses.replace(cfg3, modalities=[
        dataclasses.replace(m, n_cond=EXPORT_COND) for m in cfg3.modalities])
    m4, mc = init_assoc(0, kcfg4, device="cuda"), init_assoc(0, ccfg, device="cuda")
    kw = dict(device="cuda", compute_dtype=tc3.compute_dtype)
    # label: (kernel-path Predictor, plain Predictor, saved config, its train config)
    models = {
        "config3": (pred, plain, cfg3, tc3),
        "config4": (Predictor(m4, kcfg4, use_pallas=True, **kw),
                    Predictor(m4, cfg4, use_pallas=False, **kw), kcfg4, tc4),
        "cond": (Predictor(mc, ccfg, use_pallas=True, **kw),
                 Predictor(mc, ccfg, use_pallas=False, **kw), ccfg, tc3),
    }
    with tempfile.TemporaryDirectory() as tmp:
        # 1. Save each model and export it with the CLI on the card, the
        # three exports at once.
        procs = {}
        for label, (kp, _, cfg, tc) in models.items():
            save_params(f"{tmp}/{label}_model", kp.params, cfg,
                        dataclasses.replace(tc, use_pallas=True))
            procs[label] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "vae_assoc_tpu_torch.export", f"{tmp}/{label}_model",
                 f"{tmp}/{label}_art", "--device", "cuda"], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for label, (t0, proc) in procs.items():
            out, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"export CLI of {label} exited {proc.returncode}:\n{out}"
            with open(f"{tmp}/{label}_art/manifest.json") as f:
                manifest = json.load(f)
            assert manifest["platforms"] == ["cuda"] and len(manifest["endpoints"]) == 7
            print(f"phase 11: {label}: {out.strip()} ({time.perf_counter() - t0:.2f} s "
                  f"wall, the three CLIs at once)", flush=True)

        # 2. An artifact written on the CPU, served on the card.
        t0 = time.perf_counter()
        export_predictor(Predictor.load(f"{tmp}/config3_model", device="cpu"), f"{tmp}/cpu_art")
        print(f"phase 11: config3 exported on the CPU in {time.perf_counter() - t0:.2f} s",
              flush=True)
        t0 = time.perf_counter()
        ep3 = ExportedPredictor.load(f"{tmp}/config3_art", device="cuda")
        t1 = time.perf_counter()
        ep3.warmup((64, 128, 256, 512, 1024), all_endpoints=True)  # as ModelServer's
        print(f"phase 11: config3 artifact loaded on the card in {t1 - t0:.2f} s, warmed "
              f"(buckets 64-1024, every endpoint) in {time.perf_counter() - t1:.2f} s",
              flush=True)
        from_cpu = ExportedPredictor.load(f"{tmp}/cpu_art", device="cuda")
        assert from_cpu.manifest["platforms"] == ["cpu"]

        n = max(EXPORT_BATCHES)
        inputs = {}
        for label, (kp, *_) in models.items():
            inputs[f"{label}/img"] = rng.uniform(0, 1, (n, 784)).astype(np.float32)
            inputs[f"{label}/traj"] = rng.normal(size=(n, 200)).astype(np.float32)
            inputs[f"{label}/z"] = rng.normal(size=(n, 20)).astype(np.float32)
            if kp.cfg.n_cond:
                inputs[f"{label}/cond"] = rng.integers(0, kp.cfg.n_cond, n)
        np.savez(f"{tmp}/inputs.npz", **inputs)

        def args(label, b):
            out = [inputs[f"{label}/{k}"][:b] for k in ("img", "traj", "z")]
            return out + ([inputs[f"{label}/cond"][:b]] if f"{label}/cond" in inputs else [])

        reset_launches()
        worst = 0.0
        for b in EXPORT_BATCHES:
            want = _export_verbs(ep3, *args("config3", b))
            for name, g in _export_verbs(from_cpu, *args("config3", b)).items():
                np.testing.assert_allclose(g, want[name], rtol=EXPORT_TOL, atol=EXPORT_TOL,
                                           err_msg=f"CPU-written artifact {name} B={b}")
                worst = max(worst, float(np.abs(g - want[name]).max()))
        assert not any(launch_counts().values()), f"the artifact launched {launch_counts()}"
        print(f"phase 11: the CPU-written artifact on the card against the card-written one "
              f"at B = {', '.join(map(str, EXPORT_BATCHES))}: max abs err {worst:.3e} "
              f"(rtol=atol={EXPORT_TOL}); no kernel launched", flush=True)

        # 3. The three artifacts in a fresh process without model code,
        # against the plain and the kernel-path Predictors.
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, f"{tmp}/outputs.npz", f"{tmp}/inputs.npz",
             *(x for label in models for x in (label, f"{tmp}/{label}_art"))],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        assert child.returncode == 0, child.stderr[-4000:]
        print(f"phase 11: {child.stdout.strip()}, {time.perf_counter() - t0:.2f} s wall",
              flush=True)
        reset_launches()
        for label, (kp, pp, *_) in models.items():
            errs = {"plain": 0.0, "kernel": 0.0}
            for b in EXPORT_BATCHES:
                want = {"plain": _export_verbs(pp, *args(label, b)),
                        "kernel": _export_verbs(kp, *args(label, b))}
                with np.load(f"{tmp}/outputs.npz") as res:
                    got = {name: res[f"{label}/{b}/{name}"] for name in want["plain"]}
                for name, g in got.items():
                    assert g.shape == want["plain"][name].shape, (label, name, b, g.shape)
                    assert np.isfinite(g).all(), (label, name, b)
                    for path, tol in (("plain", EXPORT_TOL), ("kernel", TOL[kp.compute_dtype])):
                        np.testing.assert_allclose(g, want[path][name], rtol=tol, atol=tol,
                                                   err_msg=f"{label} {name} B={b} vs {path}")
                        errs[path] = max(errs[path], float(np.abs(g - want[path][name]).max()))
            print(f"phase 11: {label} artifact, 7 endpoints at B = "
                  f"{', '.join(map(str, EXPORT_BATCHES))}: max abs err {errs['plain']:.3e} "
                  f"against plain (rtol=atol={EXPORT_TOL}), {errs['kernel']:.3e} against the "
                  f"kernel path (rtol=atol={TOL[kp.compute_dtype]})", flush=True)
        launches = launch_counts()
        print(f"phase 11: launches by the kernel-path Predictors: {launches}", flush=True)
        for k in ("enc_fwd", "dec_fwd", "conv_fwd"):
            assert launches[k] > 0, f"kernel {k} was not launched by phase 11's kernel path"

        # 4. serve_http --from-export --compile-cache over HTTP, ended by SIGTERM.
        img, traj, z = (inputs[f"config3/{k}"][:5] for k in ("img", "traj", "z"))
        proc, base, start_s, _ = _serve_http(
            root, [f"{tmp}/config3_art", "--from-export", "--compile-cache", f"{tmp}/cache"], env)
        try:
            got = _http_verbs(base, img, traj, z)
        finally:
            rc, out = _stop(proc)
        assert rc == 0 and "server closed" in out, (rc, out[-3000:])
        want = _export_verbs(plain, img, traj, z)
        for name, g in got.items():
            np.testing.assert_allclose(np.asarray(g, np.float32), want[name], rtol=TOL["float32"],
                                       atol=TOL["float32"], err_msg=f"HTTP {name}")
        print(f"phase 11: serve_http --from-export --compile-cache: bound in {start_s:.2f} s, "
              f"{len(got)} routes agree with plain (rtol=atol={TOL['float32']}), SIGTERM exit 0",
              flush=True)

        # 5. A warm cache with no nvcc reachable: phase 2's library copied
        # into a fresh cache directory serves the kernel path.
        cache = f"{tmp}/warm"
        dst = os.path.join(cache, "kernels", lib_path.parent.name)
        os.makedirs(dst)
        shutil.copy2(lib_path, dst)
        mtime = os.stat(os.path.join(dst, lib_path.name)).st_mtime_ns
        os.makedirs(f"{tmp}/no_cuda")
        path = os.pathsep.join(d for d in env.get("PATH", "").split(os.pathsep)
                               if d and not os.path.exists(os.path.join(d, "nvcc")))
        no_nvcc = dict(env, CUDA_HOME=f"{tmp}/no_cuda", PATH=path)
        no_nvcc.pop("CUDA_PATH", None)
        assert shutil.which("nvcc", path=path) is None
        proc, base, start_s, lines = _serve_http(
            root, [f"{tmp}/config3_model", "--compile-cache", cache], no_nvcc)
        try:
            got = _post(base, "/v1/cross_generate", {"inputs": img.tolist(), "src": "image",
                                                     "dst": "trajectory"})["outputs"]
        finally:
            rc, out = _stop(proc)
        assert rc == 0, (rc, out[-3000:])
        assert f"compile cache: {cache}" in lines, lines
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   plain.cross_generate(img, "image", "trajectory"),
                                   rtol=TOL["float32"], atol=TOL["float32"])
        assert os.listdir(os.path.join(cache, "kernels")) == [lib_path.parent.name]
        assert os.stat(os.path.join(dst, lib_path.name)).st_mtime_ns == mtime
        print(f"phase 11: warm-cache serve_http (kernel path, no nvcc reachable): bound in "
              f"{start_s:.2f} s, against the kernel build of {build_s:.2f} s in phase 2 "
              f"[{card}]", flush=True)

        # 6. Times: the artifact against the two Predictors, and the launch floor.
        time_export_serving(ep3, pred, plain, rng, card)
    floor = time_launch_floor(card)
    print(f"phase 11 took {time.perf_counter() - t_phase:.2f} s wall", flush=True)
    return launches, floor


# ---------------------------------------------------------------------------
# Phase 12: the parallel layouts on the card
# ---------------------------------------------------------------------------

TP_PER_STEP = {"dec_fwd": 6, "dec_bwd": 6, "wgrad": 10, "reparam": 2, "loss_fwd": 1,
               "loss_bwd": 1}
"""Hand-written launches per TP step of config 3 on the kernels: per tower
a pair block in the encoder, a pair block and the depth-0 output block in
the decoder (a stack forward and backward each; 2 + 2 + 1 weight-gradient
launches), the sampler; the joint loss forward and backward."""
PAR_TOL = {"zero": (3e-5, 1e-6), "tp": 1e-3, "two_rank": (2e-5, 1e-6),
           "tp_grad": {"float32": 1e-4, "bfloat16": 1e-2}, "tp_leaf": 0.25}
"""Phase 12's tolerances: ZeRO against DP where the sums run in another
order (tests/test_zero.py's); TP's losses and gradient norms against the
single-device step, per step (rtol); two gloo ranks against the world-1
step on the global batch, every weight (tests/test_parallel.py's gradient
tolerance). TP per leaf: the step-1 gradient's error norm over its norm
(``tp_grad``, by compute dtype), and after 5 Adam steps the weights'
error norm over the leaf's movement from its initial value (``tp_leaf``).
A leaf whose gradient is missing or misplaced reads about 1 on both."""
TWO_RANK_BATCH = 1024


def _params_of(state):
    return [p.detach() for p in state.params.parameters()]


def _against(label, got, want, rtol, atol):
    """Raise unless the tensors are equal bit for bit or within rtol/atol;
    returns (bitwise, max abs err) and prints which it was."""
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not bitwise:
        assert all(torch.allclose(a, b, rtol=rtol, atol=atol) for a, b in zip(got, want)), (
            f"{label}: max abs err {err:.3e} beyond rtol {rtol} / atol {atol}")
    return bitwise, err


def _share_within(got, want, rtol, atol):
    """(share of the elements within rtol/atol, max abs err)."""
    n = bad = 0
    for a, b in zip(got, want):
        n += b.numel()
        bad += int(((a - b).abs() > atol + rtol * b.abs()).sum())
    return 1.0 - bad / n, max(float((a - b).abs().max()) for a, b in zip(got, want))


def _leaf_errs(names, got, want, base=None):
    """{leaf: ||got - want|| / ||want - base||} (``base`` None: over
    ||want||), each leaf's error norm relative to its norm or movement."""
    out = {}
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        ref = b if base is None else b - base[i]
        out[name] = float((a - b).norm()) / max(float(ref.norm()), 1e-30)
    return out


def _steps_per_s(step, state, batches, n=10):
    """(state, steps/s) over ``n`` steps, the device synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        state, _ = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    return state, n / (time.perf_counter() - t0)


def _host_and_wall(step, state, x, n=20):
    """(state, host ms, wall ms) a step over ``n`` steps on one batch: the
    host's time to enqueue them, and the time to their end on the device."""
    for _ in range(3):
        state, _ = step(state, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = step(state, x)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return state, host / n * 1e3, (time.perf_counter() - t0) / n * 1e3


def _two_rank_inputs():
    rng = np.random.default_rng(31)
    xs = [[rng.uniform(0, 1, (TWO_RANK_BATCH, 784)).astype(np.float32),
           rng.normal(size=(TWO_RANK_BATCH, 200)).astype(np.float32)] for _ in range(3)]
    eps = [[rng.normal(size=(TWO_RANK_BATCH, 20)).astype(np.float32) for _ in range(2)]
           for _ in range(3)]
    return xs, eps


def _two_rank_worker(rank):
    """One of two ranks on one card over gloo (phase 12): DP and ZeRO on
    config 3's composable path, 3 steps with this rank's rows of ε."""
    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.models import assoc as assoc_mod
    from vae_assoc_tpu_torch.parallel import dp, mesh, zero
    from vae_assoc_tpu_torch.train import step as tstep

    cfg, tc = baseline_config(3, batch_size=TWO_RANK_BATCH, use_pallas=True)
    xs, eps = _two_rank_inputs()
    m = mesh.make_mesh()
    out = {"device": str(mesh.mesh_device(m)), "backend": torch.distributed.get_backend()}
    model = assoc_mod.init_assoc(tc.seed, cfg, device="cuda")
    x0, e0 = mesh.shard_batch(m, xs[0]), list(mesh.shard_batch(m, eps[0]))
    total, _ = assoc_mod.assoc_loss_fn(model, list(x0), cfg, eps=e0, use_pallas=True,
                                       data_group=m.get_group("data"))
    grads = tstep.all_reduce_mean(torch.autograd.grad(total, list(model.parameters())),
                                  m.get_group("data"))
    out["grads"] = [g.cpu().numpy() for g in grads]
    for name, init, make in (("dp", dp.init_dp_train_state, dp.make_dp_train_step),
                             ("zero", zero.init_zero_train_state, zero.make_zero_train_step)):
        state, step, ms = init(cfg, tc, m), make(cfg, tc, m), []
        for x, e in zip(xs, eps):
            state, mt = step(state, mesh.shard_batch(m, x), eps=list(mesh.shard_batch(m, e)))
            ms.append({k: float(v) for k, v in mt.items()})
        if name == "zero":
            state = zero.gather_zero_train_state(state, cfg, tc, m)
        out[name] = ([p.detach().cpu().numpy() for p in state.params.parameters()], ms)
    return out


def parallel_check(card):
    """Phase 12; returns each kernel's launches by the layouts' own runs."""
    import dataclasses
    import shutil
    import tempfile

    import torch.distributed as dist

    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.models import assoc as assoc_mod
    from vae_assoc_tpu_torch.parallel import dp, mesh, tp, zero
    from vae_assoc_tpu_torch.train import step as tstep
    from vae_assoc_tpu_torch.train import train_loop_fused

    t_phase = time.perf_counter()
    total = {}

    def counted(fn):
        """fn() with the launch counts zeroed before it; its launches are
        added to the phase's and returned beside its result."""
        reset_launches()
        out = fn()
        got = launch_counts()
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return out, got

    def synthetic(n, seed):
        return list(PairedDataset.from_synthetic(n, seed=seed, device="cuda").features())

    tmp = tempfile.mkdtemp()
    mesh.init_distributed("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        m = mesh.make_mesh()
        print(f"phase 12: process group of world size {dist.get_world_size()} on "
              f"{dist.get_backend()}, mesh {m.mesh_dim_names} {tuple(m.shape)} on "
              f"{mesh.mesh_device(m)}; {card}", flush=True)

        # 1. DP, config 5 as shipped (composable, batch 1024 bf16, 10 steps a call).
        cfg5, tc5 = baseline_config(5)
        bs, spc = tc5.batch_size, tc5.steps_per_call
        one = dataclasses.replace(tc5, steps_per_call=1)
        rng = np.random.default_rng(12)
        batches = [synthetic(bs, 20 + i) for i in range(3)]
        eps = [[torch.from_numpy(rng.normal(size=(bs, 20)).astype(np.float32)).cuda()
                for _ in range(2)] for _ in range(3)]
        a = dp.init_dp_train_state(cfg5, one, m)
        b = tstep.init_train_state(cfg5, one, device="cuda")
        step, opt = dp.make_dp_train_step(cfg5, one, m), tstep.make_optimizer(one)
        for x, e in zip(batches, eps):
            (a, ma), _ = counted(lambda: step(a, x, eps=e))
            b, mb = tstep._one_step(b, x, cfg5, one, opt, eps=e)
            assert all(torch.equal(ma[k], mb[k]) for k in mb if k != "grad_norm"), (ma, mb)
            assert abs(float(ma["grad_norm"]) / float(mb["grad_norm"]) - 1) < 1e-6
        assert all(torch.equal(p, q) for p, q in zip(_params_of(a), _params_of(b))), (
            "DP at world size 1 differs from _one_step")
        print("phase 12: DP config 5, 3 steps with injected ε: weights and losses equal "
              "_one_step's bit for bit, grad_norm "
              f"{'bit for bit' if torch.equal(ma['grad_norm'], mb['grad_norm']) else 'within 1e-6'}",
              flush=True)
        data = synthetic(bs * spc * 2, 1)
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            (st, hist), got = counted(lambda: dp.dp_train_loop(cfg5, tc5, data, m, epochs=2))
            torch.cuda.synchronize()
            runs.append((st, hist, got, time.perf_counter() - t0))
        st, hist, got, wall = runs[0]
        want = {k: COMPOSABLE_PER_STEP.get(k, 0) * st.step for k in got}
        assert got == want, f"DP launches {got} != {want}"
        assert hist[-1]["total"] < hist[0]["total"], "DP's loss did not fall"
        assert all(torch.equal(p, q) for p, q in zip(_params_of(st), _params_of(runs[1][0]))), (
            "dp_train_loop twice from one state differs")
        t0 = time.perf_counter()
        _, fused = train_loop_fused(cfg5, tc5, data, epochs=2, device="cuda")
        fused_wall = time.perf_counter() - t0
        print(f"phase 12: dp_train_loop config 5, 2 epochs x {st.step // 2} steps: launches "
              f"exactly COMPOSABLE_PER_STEP x {st.step}, total {hist[0]['total']:.4f} -> "
              f"{hist[-1]['total']:.4f}, twice from one state to the same bits", flush=True)
        print("phase 12: config 5 samples/s, dp_train_loop (world 1) epochs "
              + ", ".join(f"{h['samples_per_sec']:.1f}" for r in runs for h in r[1])
              + f" (runs of {runs[0][3]:.2f} and {runs[1][3]:.2f} s wall); train_loop_fused "
              f"{fused[0]['samples_per_sec']:.1f} over 2 epochs ({fused_wall:.2f} s wall); "
              f"{card}", flush=True)

        # 2. ZeRO against DP: config 5 and config 3 "mega" at batch 16384 bf16.
        cfg3m, tc3m = baseline_config(3, batch_size=16384, compute_dtype="bfloat16",
                                      use_pallas="mega")
        for label, cfg, tc, xs in (("config 5", cfg5, one, batches),
                                   ("config 3 mega", cfg3m, tc3m,
                                    [synthetic(16384, 40 + i) for i in range(2)])):
            d, z = dp.init_dp_train_state(cfg, tc, m), zero.init_zero_train_state(cfg, tc, m)
            dstep, zstep = dp.make_dp_train_step(cfg, tc, m), zero.make_zero_train_step(cfg, tc, m)
            for i in range(5):
                d, md = dstep(d, xs[i % len(xs)])
                (z, mz), _ = counted(lambda: zstep(z, xs[i % len(xs)]))
                np.testing.assert_allclose(float(mz["total"]), float(md["total"]),
                                           rtol=PAR_TOL["zero"][0])
            bitwise, err = _against(f"ZeRO {label}", _params_of(
                zero.gather_zero_train_state(z, cfg, tc, m)), _params_of(d), *PAR_TOL["zero"])
            rates = []
            for _ in range(2):
                d, r_d = _steps_per_s(dstep, d, xs)
                (z, r_z), _ = counted(lambda: _steps_per_s(zstep, z, xs))
                rates.append((r_d, r_z))
            print(f"phase 12: ZeRO {label}, 5 steps against DP from one state and seed: "
                  + ("weights equal bit for bit (one rank: the sums run in one order)"
                     if bitwise else f"weights within rtol {PAR_TOL['zero'][0]} / atol "
                     f"{PAR_TOL['zero'][1]} (max abs err {err:.3e}: the gradient sum and "
                     "Adam run on flat slices in another order)")
                  + "; steps/s DP / ZeRO " + ", ".join(f"{x:.1f} / {y:.1f}" for x, y in rates)
                  + f" (batch {tc.batch_size} {tc.compute_dtype}, use_pallas={tc.use_pallas!r}; "
                  f"{card})", flush=True)

        # 3. ZeRO on config 4's conv_pallas tower, batch 64 fp32, the conv kernels.
        cfg4, tc4 = baseline_config(4, use_pallas=True)
        cfg4 = _conv_pallas(cfg4)
        xs4 = [synthetic(64, 50 + i) for i in range(3)]
        d, z = dp.init_dp_train_state(cfg4, tc4, m), zero.init_zero_train_state(cfg4, tc4, m)
        dstep, zstep = dp.make_dp_train_step(cfg4, tc4, m), zero.make_zero_train_step(cfg4, tc4, m)
        conv = {}
        for x in xs4:
            d, md = dstep(d, x)
            (z, mz), got = counted(lambda: zstep(z, x))
            conv = {k: conv.get(k, 0) + v for k, v in got.items()}
            np.testing.assert_allclose(float(mz["total"]), float(md["total"]),
                                       rtol=PAR_TOL["zero"][0])
        bitwise, err = _against("ZeRO config 4", _params_of(
            zero.gather_zero_train_state(z, cfg4, tc4, m)), _params_of(d), *PAR_TOL["zero"])
        assert conv["conv_fwd"] > 0 and conv["conv_dw"] > 0, conv
        print(f"phase 12: ZeRO config 4 conv_pallas, 3 steps against DP: "
              f"{'bit for bit' if bitwise else f'max abs err {err:.3e}'}; launches {conv}",
              flush=True)

        # 4. TP on config 3, the blocks on the stack kernels, against the
        # single-device composable step from one state and seed.
        tm = tp.make_tp_mesh()
        cfg3, _ = baseline_config(3)
        xs3 = [synthetic(1024, 60 + i) for i in range(5)]
        for cd in ("float32", "bfloat16"):
            tc = baseline_config(3, batch_size=1024, use_pallas=True, compute_dtype=cd)[1]
            ts = tp.init_tp_train_state(cfg3, tc, tm)
            ref = tstep.init_train_state(cfg3, tc, device="cuda")
            names = [k for k, _ in ref.params.named_parameters()]
            init = [p.clone() for p in _params_of(ref)]
            tstep_fn, rstep = tp.make_tp_train_step(cfg3, tc, tm), tstep.make_train_step(cfg3, tc)
            # Step 1's gradients, leaf by leaf, with one injected ε.
            e0 = [torch.from_numpy(rng.normal(size=(1024, 20)).astype(np.float32)).cuda()
                  for _ in range(2)]
            lt, _ = tp._tp_loss_fn(ts.params, xs3[0], cfg3, tp._splits(cfg3, tc, tm),
                                   use_pallas=True, eps=e0)
            lr_, _ = assoc_mod.assoc_loss_fn(ref.params, xs3[0], cfg3, eps=e0, compute_dtype=cd,
                                             use_pallas=True)
            gt = torch.autograd.grad(lt, list(ts.params.parameters()))
            gr = torch.autograd.grad(lr_, list(ref.params.parameters()))
            assert [g.shape for g in gt] == [g.shape for g in gr]
            gerr = _leaf_errs(names, gt, gr)
            gworst = max(gerr, key=gerr.get)
            assert gerr[gworst] <= PAR_TOL["tp_grad"][cd], (
                f"TP {cd} step-1 gradient of {gworst}: error norm {gerr[gworst]:.3e} of its norm")
            worst = 0.0
            for x in xs3:
                (ts, mt), got = counted(lambda: tstep_fn(ts, x))
                ref, mr = rstep(ref, x)
                assert got == {k: TP_PER_STEP.get(k, 0) for k in got}, f"TP launches {got}"
                for k in ("total", "grad_norm"):
                    rel = abs(float(mt[k]) / float(mr[k]) - 1)
                    worst = max(worst, rel)
                    assert rel <= PAR_TOL["tp"], f"TP {cd} {k}: {float(mt[k])} vs {float(mr[k])}"
            full = tp.gather_tp_train_state(ts, cfg3, tc, tm)
            share, err = _share_within(_params_of(full), _params_of(ref), PAR_TOL["tp"], 1e-5)
            assert share >= 0.999, f"TP {cd}: {share:.6f} of the weights within rtol 1e-3"
            werr = _leaf_errs(names, _params_of(full), _params_of(ref), init)
            wworst = max(werr, key=werr.get)
            lshare = {k: _share_within([a], [b], PAR_TOL["tp"], 1e-5)[0] for k, a, b in
                      zip(names, _params_of(full), _params_of(ref))}
            sworst = min(lshare, key=lshare.get)
            assert werr[wworst] <= PAR_TOL["tp_leaf"], (
                f"TP {cd} weights of {wworst}: error norm {werr[wworst]:.3e} of the leaf's "
                "movement in 5 steps")
            back = tp.gather_tp_train_state(tp.shard_tp_train_state(tm, full, cfg3, tc), cfg3,
                                            tc, tm)
            assert all(torch.equal(p, q) for p, q in zip(_params_of(back), _params_of(full)))
            ts, r1 = counted(lambda: _steps_per_s(tstep_fn, ts, xs3))[0]
            ref, r2 = _steps_per_s(rstep, ref, xs3)
            ts, r3 = counted(lambda: _steps_per_s(tstep_fn, ts, xs3))[0]
            print(f"phase 12: TP config 3 {cd} batch 1024 (world 1, no pads): step-1 "
                  f"gradients per leaf within error norm {gerr[gworst]:.3e} of the composable "
                  f"step's (worst {gworst}; limit {PAR_TOL['tp_grad'][cd]}); 5 steps, losses "
                  f"and grad norms within rel {worst:.2e} of the composable step (rtol "
                  f"{PAR_TOL['tp']}), {share:.6f} of the weights within rtol 1e-3 / atol 1e-5 "
                  f"(max abs err {err:.3e}; worst leaf by share {sworst} "
                  f"{lshare[sworst]:.6f}), per leaf error norm {werr[wworst]:.3e} of its "
                  f"movement (worst {wworst}; limit {PAR_TOL['tp_leaf']}); launches exactly "
                  f"TP_PER_STEP a step; gather/shard "
                  f"round trip bit for bit; steps/s TP {r1:.1f}, {r3:.1f}, composable {r2:.1f} "
                  f"({card})", flush=True)

        # Where a step's time goes at batch 1024: the host's enqueue against
        # the wall, per layout, and one NCCL all-reduce at world size 1.
        tc = baseline_config(3, batch_size=1024, use_pallas=True)[1]
        x = xs3[0]
        steps = {"single-device": (tstep.init_train_state(cfg3, tc, device="cuda"),
                                   tstep.make_train_step(cfg3, tc)),
                 "DP": (dp.init_dp_train_state(cfg3, tc, m), dp.make_dp_train_step(cfg3, tc, m)),
                 "ZeRO": (zero.init_zero_train_state(cfg3, tc, m),
                          zero.make_zero_train_step(cfg3, tc, m)),
                 "TP": (tp.init_tp_train_state(cfg3, tc, tm), tp.make_tp_train_step(cfg3, tc, tm))}
        line = []
        for label, (st, step) in steps.items():
            _, host, wall = _host_and_wall(step, st, x)
            line.append(f"{label} {host:.3f} / {wall:.3f}")
        costs = []
        for numel in (2_049_064, 8):
            t = torch.zeros(numel, device="cuda")
            for _ in range(5):
                dist.all_reduce(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                dist.all_reduce(t)
            torch.cuda.synchronize()
            costs.append((time.perf_counter() - t0) / 100 * 1e3)
        print("phase 12: config 3 composable fp32 batch 1024, host enqueue / wall ms a step: "
              + ", ".join(line) + f"; an NCCL all-reduce at world size 1, back to back: "
              f"{costs[0]:.4f} ms of 8 MB, {costs[1]:.4f} ms of 32 B ({card})", flush=True)

        # 5. Two ranks on the one card, over gloo with CUDA tensors.
        t0 = time.perf_counter()
        ranks = mesh.spawn(_two_rank_worker, 2, device_type="cuda", backend="gloo",
                           timeout_s=300)
        xs, eps2 = _two_rank_inputs()
        cfg, tc = baseline_config(3, batch_size=TWO_RANK_BATCH, use_pallas=True)
        model = assoc_mod.init_assoc(tc.seed, cfg, device="cuda")
        cuda = [[torch.from_numpy(a).cuda() for a in x] for x in xs]
        ceps = [[torch.from_numpy(a).cuda() for a in e] for e in eps2]
        total_loss, _ = assoc_mod.assoc_loss_fn(model, cuda[0], cfg, eps=ceps[0], use_pallas=True)
        g_ref = torch.autograd.grad(total_loss, list(model.parameters()))
        ref, opt, ref_ms = tstep.init_train_state(cfg, tc, device="cuda"), \
            tstep.make_optimizer(tc), []
        for x, e in zip(cuda, ceps):
            ref, mr = tstep._one_step(ref, x, cfg, tc, opt, eps=e)
            ref_ms.append({k: float(v) for k, v in mr.items()})
        rtol, atol = PAR_TOL["two_rank"]
        want = [p.cpu().numpy() for p in _params_of(ref)]
        for r, res in enumerate(ranks):
            for g, w in zip(res["grads"], g_ref):
                np.testing.assert_allclose(g, w.cpu().numpy(), rtol=rtol, atol=atol)
            for name in ("dp", "zero"):
                params, ms = res[name]
                assert all(np.array_equal(p, q) for p, q in zip(params, ranks[0][name][0]))
                for mt, mr in zip(ms, ref_ms):
                    for k in ("total", "grad_norm"):
                        np.testing.assert_allclose(mt[k], mr[k], rtol=rtol)
        assert all(np.array_equal(p, q) for p, q in zip(ranks[0]["zero"][0], ranks[0]["dp"][0])), (
            "two ranks: ZeRO's weights differ from DP's")
        bitwise, err = _against("two ranks' weights after 3 steps",
                                [torch.from_numpy(p) for p in ranks[0]["dp"][0]],
                                [torch.from_numpy(p) for p in want], rtol, atol)
        print(f"phase 12: two ranks on {ranks[0]['device']} over {ranks[0]['backend']}, "
              f"config 3 composable batch {TWO_RANK_BATCH} fp32 with injected ε: step-1 "
              f"gradients within rtol {rtol} / atol {atol} of the world-1 step's, losses and "
              f"grad norms of 3 steps within rtol {rtol}, both ranks' weights equal and ZeRO's "
              f"equal DP's bit for bit; every weight after 3 Adam steps "
              f"{'equal to' if bitwise else f'within rtol {rtol} / atol {atol} of'} the "
              f"world-1 step's (max abs err {err:.3e}); "
              f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 12: launches by the layouts' runs: {total}", flush=True)
    print(f"phase 12 took {time.perf_counter() - t_phase:.2f} s wall", flush=True)
    return total


# ---------------------------------------------------------------------------
# Phase 13: TP on a conv tower and with remat, TP × FSDP, and the GPipe ring
# ---------------------------------------------------------------------------

L_STEPS = 5  # phase 13's steps a layout, with injected ε
PP_DEPTH, PP_MICRO, PP_BATCH = 5, 4, 1024
L_SEEDS = {"conv": 41, "tpf": 42, "pp": 43}


def _tp_conv_cfg():
    """Config 4 (28×28 → 32 → 64 → 500 → 20 conv image tower and the MLP
    trajectory tower) on the plain convs, batch 64 fp32: what the GSPMD TP
    names split by channels."""
    import dataclasses

    from vae_assoc_tpu_torch.configs import baseline_config

    cfg, tc = baseline_config(4, use_pallas=False)
    assert cfg.modalities[0].encoder == "conv"
    return cfg, dataclasses.replace(tc, steps_per_call=1)


def _pp_cfg():
    """Config 3's widths deepened to 5 hidden layers of 500 per net
    (784-500×5-20 Bernoulli image, 200-500×5-20 Gaussian trajectory), the
    depth ``configs.validate_arch`` admits; batch 1024 fp32, plain."""
    import dataclasses

    from vae_assoc_tpu_torch.configs import (baseline_config, default_image_arch,
                                             default_traj_arch)

    cfg, tc = baseline_config(3, batch_size=PP_BATCH)
    arches = (default_image_arch(depth=PP_DEPTH), default_traj_arch(depth=PP_DEPTH))
    mods = [dataclasses.replace(m, arch=a) for m, a in zip(cfg.modalities, arches)]
    return dataclasses.replace(cfg, modalities=mods), tc


def _l_inputs(cfg, batch, seed, steps=L_STEPS):
    """``steps`` (batch list, ε list) pairs as numpy, the same in every
    process: images in [0, 1), trajectories normal."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        xs = [rng.uniform(0, 1, (batch, m.arch["n_input"])).astype(np.float32)
              if m.recon == "bernoulli" else
              rng.normal(size=(batch, m.arch["n_input"])).astype(np.float32)
              for m in cfg.modalities]
        out.append((xs, [rng.normal(size=(batch, m.arch["n_z"])).astype(np.float32)
                         for m in cfg.modalities]))
    return out


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _cuda(arrays):
    return [torch.from_numpy(a).cuda() for a in arrays]


def _drive(step, state, inputs, shard=_cuda):
    """(state, per-step metrics as floats) of ``step`` over the inputs with
    their ε (``shard`` places a batch list and an ε list)."""
    ms = []
    for xs, eps in inputs:
        state, mt = step(state, shard(xs), eps=list(shard(eps)))
        ms.append({k: float(v) for k, v in mt.items()})
    return state, ms


def _rate(step, state, x, n=10):
    """(state, steps/s, host enqueue ms a step) over ``n`` steps on one batch."""
    state, host, wall = _host_and_wall(step, state, x, n=n)
    return state, 1e3 / wall, host


def _pair_worker(rank):
    """One of two gloo ranks sharing the card (phase 13): TP on config 4's
    conv tower through the GSPMD names (channel splits 16/32), then PP over
    2 stages on the deepened config 3, run twice from one state."""
    from vae_assoc_tpu_torch import parallel
    from vae_assoc_tpu_torch.parallel import pp, tp

    out = {"device": f"cuda:{torch.cuda.current_device()}",
           "backend": torch.distributed.get_backend()}
    cfg, tc = _tp_conv_cfg()
    m = tp.make_tp_mesh()
    st = tp.init_tp_train_state(cfg, tc, m)
    out["conv_shapes"] = [tuple(st.params.modalities[0].recog[k].w.shape)
                          for k in ("conv1", "conv2")]
    step = parallel.make_tp_train_step(cfg, tc, m)
    inputs = _l_inputs(cfg, tc.batch_size, L_SEEDS["conv"])
    st, ms = _drive(step, st, inputs)
    full = tp.gather_tp_train_state(st, cfg, tc, m)
    out["tp_conv"] = (ms, [p.detach().cpu().numpy() for p in full.params.parameters()])
    out["tp_conv_rate"] = _rate(step, st, _cuda(inputs[0][0]))[1:]
    cfg, tc = _pp_cfg()
    pm = pp.make_pp_mesh()
    inputs = _l_inputs(cfg, tc.batch_size, L_SEEDS["pp"])
    runs = []
    for _ in range(2):
        st = pp.init_pp_train_state(cfg, tc, pm)
        step = pp.make_pp_train_step(cfg, tc, pm, n_micro=PP_MICRO)
        st, ms = _drive(step, st, inputs)
        full = pp.gather_pp_train_state(st, cfg, tc, pm)
        runs.append((ms, [p.detach().cpu().numpy() for p in full.params.parameters()]))
    out["pp"] = runs[0]
    out["pp_bits"] = runs[0][0] == runs[1][0] and all(
        np.array_equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    out["pp_mid"] = tuple(st.params.modalities[0].recog["mid"].w.shape)
    out["pp_rate"] = _rate(step, st, _cuda(inputs[0][0]))[1:]
    return out


def _tpf_cfg():
    """Config 5 (composable kernels, batch 1024 bf16), one step a call."""
    import dataclasses

    from vae_assoc_tpu_torch.configs import baseline_config

    cfg, tc = baseline_config(5)
    return cfg, dataclasses.replace(tc, steps_per_call=1)


def _tpf_worker(rank):
    """One of four gloo ranks sharing the card (phase 13): TP × FSDP on a
    2 × 2 mesh, config 5 (composable kernels, batch 1024 bf16), this rank's
    rows of each batch and of ε."""
    from vae_assoc_tpu_torch.parallel import tp, tp_fsdp

    cfg, tc = _tpf_cfg()
    m = tp.make_tp_mesh(4, data_parallel=2)
    st = tp_fsdp.init_tp_fsdp_train_state(cfg, tc, m)
    step = tp_fsdp.make_tp_fsdp_train_step(cfg, tc, m)
    inputs = _l_inputs(cfg, tc.batch_size, L_SEEDS["tpf"])
    st, ms = _drive(step, st, inputs, shard=lambda a: tp.shard_tp_batch(m, a))
    full = tp_fsdp.gather_tp_fsdp_train_state(st, cfg, tc, m)
    return {"ms": ms, "params": [p.detach().cpu().numpy() for p in full.params.parameters()],
            "slice_numel": sum(t.numel() for t in st.params),
            "rate": _rate(step, st, tp.shard_tp_batch(m, inputs[0][0]))[1:]}


def _layout_gate(label, names, got, want, init, ms_got, ms_want):
    """PR 13's TP gate: every step's loss and gradient norm within rel
    PAR_TOL["tp"], 99.9 % of the weights within rtol PAR_TOL["tp"] / atol
    1e-5, every leaf's error norm within PAR_TOL["tp_leaf"] of its movement
    from ``init``. Returns a line that says what held."""
    rel = 0.0
    for mg, mw in zip(ms_got, ms_want):
        for k in ("total", "grad_norm"):
            r = abs(mg[k] / mw[k] - 1)
            rel = max(rel, r)
            assert r <= PAR_TOL["tp"], f"{label} {k}: {mg[k]} vs {mw[k]}"
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    share, err = _share_within(got, want, PAR_TOL["tp"], 1e-5)
    assert share >= 0.999, f"{label}: {share:.6f} of the weights within rtol 1e-3"
    werr = _leaf_errs(names, got, want, init)
    worst = max(werr, key=werr.get)
    assert werr[worst] <= PAR_TOL["tp_leaf"], (
        f"{label} weights of {worst}: error norm {werr[worst]:.3e} of the leaf's movement")
    if bitwise:
        return "weights and losses bit for bit"
    return (f"losses and grad norms within rel {rel:.2e}, {share:.6f} of the weights within "
            f"rtol 1e-3 / atol 1e-5 (max abs err {err:.3e}), per leaf error norm "
            f"{werr[worst]:.3e} of its movement (worst {worst})")


def layouts_check(card):
    """Phase 13; returns each kernel's launches by the layouts' own runs."""
    import dataclasses
    import shutil
    import tempfile

    import torch.distributed as dist

    from vae_assoc_tpu_torch import parallel
    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.models import assoc as assoc_mod
    from vae_assoc_tpu_torch.parallel import mesh, tp, tp_fsdp
    from vae_assoc_tpu_torch.train import step as tstep

    t_phase = time.perf_counter()
    total = {}

    def counted(fn):
        """fn() with the launch counts zeroed before it; its launches are
        added to the phase's and returned beside its result."""
        reset_launches()
        out = fn()
        got = launch_counts()
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return out, got

    def single(cfg, tc, inputs):
        st = tstep.init_train_state(cfg, tc, device="cuda")
        init = [p.detach().clone() for p in st.params.parameters()]
        st, ms = _drive(tstep.make_train_step(cfg, tc), st, inputs)
        return st, ms, init

    def named(cfg):
        return [k for k, _ in assoc_mod.AssocVAE(cfg, device="meta").named_parameters()]

    tmp = tempfile.mkdtemp()
    mesh.init_distributed("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        m1 = tp.make_tp_mesh()
        # 1. TP on config 4's conv tower (GSPMD names), world 1, against the
        # single-device plain step with the same ε.
        cfg4, tc4 = _tp_conv_cfg()
        conv_in = _l_inputs(cfg4, tc4.batch_size, L_SEEDS["conv"])
        ref4, ref4_ms, init4 = single(cfg4, tc4, conv_in)
        ts = tp.init_tp_train_state(cfg4, tc4, m1)
        step = parallel.make_tp_train_step(cfg4, tc4, m1)
        (ts, tp4_ms), got = counted(lambda: _drive(step, ts, conv_in))
        tp4 = _params_of(tp.gather_tp_train_state(ts, cfg4, tc4, m1))
        names4 = named(cfg4)
        line = _layout_gate("TP config 4 conv", names4, tp4, _params_of(ref4), init4, tp4_ms,
                            ref4_ms)
        x4 = _cuda(conv_in[0][0])
        ts, r_tp, h_tp = _rate(step, ts, x4)
        _, r_sd, h_sd = _rate(tstep.make_train_step(cfg4, tc4), ref4, x4)
        print(f"phase 13: TP config 4 conv tower (GSPMD names, plain convs) batch 64 fp32, world "
              f"1, {L_STEPS} steps with injected ε against the single-device step: {line}; "
              f"launches {_nonzero(got)}; steps/s TP {r_tp:.1f}, single-device {r_sd:.1f}; "
              f"samples/s {64 * r_tp:.1f}, {64 * r_sd:.1f}; host enqueue ms a step {h_tp:.3f}, "
              f"{h_sd:.3f} ({card})", flush=True)

        # 2. remat on config 3's TP step (the kernels inside the checkpoint).
        cfg3, tc3 = baseline_config(3, batch_size=1024, use_pallas=True)
        rem = dataclasses.replace(tc3, remat=True)
        in3 = _l_inputs(cfg3, 1024, 44)
        a, b = tp.init_tp_train_state(cfg3, tc3, m1), tp.init_tp_train_state(cfg3, rem, m1)
        init3 = _params_of(tp.gather_tp_train_state(a, cfg3, tc3, m1))
        init3 = [p.clone() for p in init3]
        sa, sb = parallel.make_tp_train_step(cfg3, tc3, m1), parallel.make_tp_train_step(
            cfg3, rem, m1)
        a, ms_a = _drive(sa, a, in3)
        (b, ms_b), got = counted(lambda: _drive(sb, b, in3))
        line = _layout_gate("TP config 3 remat", named(cfg3),
                            _params_of(tp.gather_tp_train_state(b, cfg3, rem, m1)),
                            _params_of(tp.gather_tp_train_state(a, cfg3, tc3, m1)), init3,
                            ms_b, ms_a)
        x3 = _cuda(in3[0][0])
        b, r_rem, h_rem = _rate(sb, b, x3)
        a, r_tp3, h_tp3 = _rate(sa, a, x3)
        print(f"phase 13: TP config 3 composable batch 1024 fp32 with remat=True against "
              f"remat=False, world 1, {L_STEPS} steps with injected ε: {line}; launches "
              f"{ {k: v // L_STEPS for k, v in _nonzero(got).items()} } a step (the forward's "
              f"twice); steps/s remat {r_rem:.1f}, TP {r_tp3:.1f}; host ms {h_rem:.3f}, "
              f"{h_tp3:.3f} ({card})", flush=True)

        # 3. TP × FSDP on config 5 at world 1 on a 1 × 1 ("data", "model")
        # mesh, against TP on the same mesh from one seed: bit for bit, TP's
        # launches; then with injected ε, the reference of the 2 × 2 ranks.
        cfg5, tc5 = _tpf_cfg()
        m11 = mesh.make_mesh(1, model_axis="model", model_parallel=1)
        tpf_in = _l_inputs(cfg5, tc5.batch_size, L_SEEDS["tpf"])
        t5 = tp.init_tp_train_state(cfg5, tc5, m11)
        f5 = tp_fsdp.init_tp_fsdp_train_state(cfg5, tc5, m11)
        st5, sf5 = (parallel.make_tp_train_step(cfg5, tc5, m11),
                    tp_fsdp.make_tp_fsdp_train_step(cfg5, tc5, m11))
        for xs, _ in tpf_in:
            (t5, mt), got_t = counted(lambda: st5(t5, _cuda(xs)))
            (f5, mf), got_f = counted(lambda: sf5(f5, _cuda(xs)))
            want = {k: TP_PER_STEP.get(k, 0) for k in got_f}
            assert got_f == want and got_t == want, f"launches TP {got_t}, TP×FSDP {got_f}"
            assert all(torch.equal(mt[k], mf[k]) for k in mt if k != "grad_norm"), (mt, mf)
            assert abs(float(mf["grad_norm"]) / float(mt["grad_norm"]) - 1) < 1e-6
        assert all(torch.equal(p, q) for p, q in zip(
            _params_of(tp_fsdp.gather_tp_fsdp_train_state(f5, cfg5, tc5, m11)),
            _params_of(tp.gather_tp_train_state(t5, cfg5, tc5, m11)))), (
            "TP×FSDP at world 1 differs from TP")
        x5 = _cuda(tpf_in[0][0])
        f5, r_f, h_f = counted(lambda: _rate(sf5, f5, x5))[0]
        t5, r_t, h_t = counted(lambda: _rate(st5, t5, x5))[0]
        sd5 = tstep.init_train_state(cfg5, tc5, device="cuda")
        _, r_s, h_s = _rate(tstep.make_train_step(cfg5, tc5), sd5, x5)
        f1, ms_f = counted(lambda: _drive(sf5, tp_fsdp.init_tp_fsdp_train_state(cfg5, tc5, m11),
                                          tpf_in))[0]
        tpf1 = _params_of(tp_fsdp.gather_tp_fsdp_train_state(f1, cfg5, tc5, m11))
        print(f"phase 13: TP×FSDP config 5 (composable, batch 1024 bf16) at world 1 against TP "
              f"on the same 1 × 1 mesh from one seed, {L_STEPS} steps: weights and losses bit "
              "for bit, grad norms within 1e-6, launches exactly TP_PER_STEP a step; steps/s "
              f"TP×FSDP {r_f:.1f}, TP {r_t:.1f}, single-device {r_s:.1f}; samples/s "
              f"{1024 * r_f:.1f}, {1024 * r_t:.1f}, {1024 * r_s:.1f}; host enqueue ms a step "
              f"{h_f:.3f}, {h_t:.3f}, {h_s:.3f} ({card})", flush=True)

        # 4. Two gloo ranks on the card: TP conv against world 1, PP against
        # the single-device plain step, PP twice to the same bits.
        t0 = time.perf_counter()
        pair = mesh.spawn(_pair_worker, 2, device_type="cuda", backend="gloo", timeout_s=300)
        for r, res in enumerate(pair):
            assert res["conv_shapes"] == [(3, 3, 1, 16), (3, 3, 16, 64)], res["conv_shapes"]
            ms, params = res["tp_conv"]
            line_c = _layout_gate(f"TP conv rank {r}", names4,
                                  [torch.from_numpy(p) for p in params], [p.cpu() for p in tp4],
                                  [p.cpu() for p in init4], ms, tp4_ms)
        cfgp, tcp = _pp_cfg()
        pp_in = _l_inputs(cfgp, tcp.batch_size, L_SEEDS["pp"])
        refp, refp_ms, _ = single(cfgp, tcp, pp_in)
        namesp = named(cfgp)
        rel = 0.0
        for r, res in enumerate(pair):
            assert res["pp_bits"], f"PP rank {r}: two runs from one state differ"
            ms, params = res["pp"]
            for mg, mw in zip(ms, refp_ms):
                for k in ("total", "grad_norm"):
                    rel = max(rel, abs(mg[k] / mw[k] - 1))
            assert rel <= PAR_TOL["tp"], f"PP rank {r}: losses off by rel {rel:.3e}"
            perr = _leaf_errs(namesp, [torch.from_numpy(p) for p in params],
                              [p.cpu() for p in _params_of(refp)])
            pworst = max(perr, key=perr.get)
            assert perr[pworst] <= PAR_TOL["tp"], (
                f"PP rank {r} leaf {pworst}: error norm {perr[pworst]:.3e} of its norm")
        pshare, perr_max = _share_within([torch.from_numpy(p) for p in pair[0]["pp"][1]],
                                         [p.cpu() for p in _params_of(refp)], PAR_TOL["tp"], 1e-5)
        _, r_p, h_p = _rate(tstep.make_train_step(cfgp, tcp), refp, _cuda(pp_in[0][0]))
        print(f"phase 13: two gloo ranks on {pair[0]['device']} over {pair[0]['backend']}: TP "
              f"config 4 conv (channel splits 16/32) against world 1: {line_c}; steps/s "
              f"{pair[0]['tp_conv_rate'][0]:.1f} (samples/s "
              f"{64 * pair[0]['tp_conv_rate'][0]:.1f}), host ms "
              f"{pair[0]['tp_conv_rate'][1]:.3f}; PP "
              f"S = 2, M = {PP_MICRO}, config 3 deepened to {PP_DEPTH} × 500 (mid block "
              f"{pair[0]['pp_mid']}), batch {PP_BATCH} fp32, {L_STEPS} steps with injected ε "
              f"against the single-device plain step: losses and grad norms within rel "
              f"{rel:.2e}, every leaf within error norm {perr[pworst]:.3e} of its norm (worst "
              f"{pworst}; limit {PAR_TOL['tp']}), {pshare:.6f} of the weights within rtol 1e-3 "
              f"/ atol 1e-5 (max abs err {perr_max:.3e}), identical bits twice; steps/s PP "
              f"{pair[0]['pp_rate'][0]:.1f} (host ms {pair[0]['pp_rate'][1]:.3f}), "
              f"single-device {r_p:.1f} (host ms {h_p:.3f}); samples/s "
              f"{PP_BATCH * pair[0]['pp_rate'][0]:.1f}, {PP_BATCH * r_p:.1f}; "
              f"{time.perf_counter() - t0:.2f} s wall ({card})", flush=True)

        # 5. Four gloo ranks on the card: TP × FSDP 2 × 2 against world 1.
        t0 = time.perf_counter()
        quad = mesh.spawn(_tpf_worker, 4, device_type="cuda", backend="gloo", timeout_s=300)
        init5 = [p.cpu() for p in _params_of(tstep.init_train_state(cfg5, tc5, device="cuda"))]
        for r, res in enumerate(quad):
            line_q = _layout_gate(f"TP×FSDP 2×2 rank {r}", named(cfg5),
                                  [torch.from_numpy(p) for p in res["params"]],
                                  [p.cpu() for p in tpf1], init5, res["ms"], ms_f)
        numel = sum(p.numel() for p in tpf1)
        print(f"phase 13: four gloo ranks, TP×FSDP 2 × 2 on config 5 against world 1, "
              f"{L_STEPS} steps with injected ε: {line_q}; a rank stores "
              f"{quad[0]['slice_numel']} of {numel} weights "
              f"({quad[0]['slice_numel'] / numel:.4f}); "
              f"steps/s {quad[0]['rate'][0]:.1f} (samples/s {1024 * quad[0]['rate'][0]:.1f}), "
              f"host ms {quad[0]['rate'][1]:.3f}; "
              f"{time.perf_counter() - t0:.2f} s wall ({card})", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 13: launches by the layouts' runs: {_nonzero(total)}", flush=True)
    print(f"phase 13 took {time.perf_counter() - t_phase:.2f} s wall", flush=True)
    return total


CLI_ROWS = 4096  # phase 9's synthetic pairs
CLI_C5_ROWS = 20480  # config 5: two calls of ten 1024-row steps an epoch
SWEEP_LAMBDAS = (0.5, 1.0, 2.0)
SWEEP_STEPS = 5


def _cli_keys(cfg, val: bool) -> list:
    """The JAX CLI's record keys for a run of ``cfg`` without a sweep, in
    order: each epoch's training means and (with --val-frac) validation,
    then the MSE grid and the recognition scores of the final weights
    (tests/test_torch_driver.py holds the port's against the JAX CLI's)."""
    names = [m.name for m in cfg.modalities]
    terms = [f"{t}_{n}" for n in names for t in ("recon", "kl")] + ["assoc", "total"]
    pairs = [f"{a}->{b}" for a in names for b in names]
    epoch = sorted(["t", "epoch", "grad_norm", "samples_per_sec"] + terms)
    valid = sorted(["t", "epoch"] + [f"val_{k}" for k in terms + pairs])
    knn = sorted(["t"] + [f"knn_{a}" if a == b else f"knn_{a}->{b}"
                          for a in names for b in names])
    per_epoch = [epoch, valid] if val else [epoch]
    return per_epoch * 2 + [sorted(["t"] + [f"mse_{p}" for p in pairs]), knn]


def _cli(argv, what) -> float:
    """The training CLI in this process (its exit code must be 0); its wall s."""
    from vae_assoc_tpu_torch.train import driver

    t0 = time.perf_counter()
    rc = driver.main([str(a) for a in argv])
    assert rc == 0, f"phase 14 {what}: the CLI exited {rc}"
    return time.perf_counter() - t0


def _cli_totals(recs, what):
    """The epochs' training totals of a CLI run, finite and falling."""
    totals = [r["total"] for r in recs if "samples_per_sec" in r]
    assert len(totals) >= 2 and np.all(np.isfinite(totals)) and totals[-1] < totals[0], \
        f"phase 14 {what}: epoch totals {totals}"
    return totals


def _cli_zero_worker(rank, root):
    """One of two gloo ranks sharing the card (phase 14): the CLI under
    --mesh 2 --zero on config 5 for one epoch, and the whole state it
    gathers at the end."""
    from vae_assoc_tpu_torch import parallel as par
    from vae_assoc_tpu_torch.train import driver

    gather, got = par.gather_zero_train_state, []

    def keep(*a, **kw):
        got.append(gather(*a, **kw))
        return got[-1]

    par.gather_zero_train_state = keep
    rc = driver.main(["--config", "5", "--mesh", "2", "--zero", "--epochs", "1",
                      "--n-samples", str(CLI_C5_ROWS), "--metrics",
                      os.path.join(root, "zero.jsonl")])
    return {"rc": rc, "backend": torch.distributed.get_backend(),
            "weights": [p.detach().cpu().numpy() for p in got[-1].params.parameters()]}


def cli_check(card):
    """Phase 14; returns each kernel's launches by the in-process CLI runs."""
    import contextlib
    import copy
    import dataclasses
    import io
    import shutil
    import signal
    import tempfile

    from vae_assoc_tpu_torch import graft_entry
    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data.pipeline import PairedDataset
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.models import assoc as assoc_mod
    from vae_assoc_tpu_torch.parallel.mesh import spawn
    from vae_assoc_tpu_torch.serve import Predictor
    from vae_assoc_tpu_torch.train import sweep
    from vae_assoc_tpu_torch.train.loop import train_loop, train_loop_fused
    from vae_assoc_tpu_torch.train.step import init_train_state, make_train_step
    from vae_assoc_tpu_torch.utils import checkpoint as ckpt
    from vae_assoc_tpu_torch.utils.logging import read_jsonl

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    launches = {}

    def counted(argv, what):
        reset_launches()
        secs = _cli(argv, what)
        counts = launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return secs, counts

    tmp = tempfile.mkdtemp(prefix="phase14_")
    try:
        # Config 3 at full width on the composable kernels (it ships on the
        # plain path, and no flag of the CLI selects the megakernel).
        cfg3, tc3 = baseline_config(3, use_pallas=True)
        c3 = ["--config", "3", "--use-pallas", "--n-samples", CLI_ROWS, "--val-frac", "0.1"]
        ck, m3 = os.path.join(tmp, "c3"), os.path.join(tmp, "c3.jsonl")
        saved, save = [], ckpt.save

        def capture(path, state, **kw):  # the trained weights the CLI saves
            saved.append(copy.deepcopy(state.params))
            return save(path, state, **kw)

        ckpt.save = capture
        try:
            secs, counts = counted(c3 + ["--epochs", 2, "--metrics", m3, "--ckpt-dir", ck],
                                   "config 3")
        finally:
            ckpt.save = save
        recs = read_jsonl(m3)
        got_keys = [sorted(r) for r in recs]
        assert got_keys == _cli_keys(cfg3, True), f"phase 14: record keys {got_keys}"
        totals = _cli_totals(recs, "config 3")
        for k in COMPOSABLE_PER_STEP:
            assert counts[k] > 0, f"phase 14: the CLI on config 3 launched no {k}"
        step3 = ckpt.latest_step(ck)
        spe = (CLI_ROWS - int(np.ceil(CLI_ROWS * 0.1))) // tc3.batch_size
        assert step3 == 2 * spe, (step3, spe)
        pred = Predictor.from_checkpoint(ck, cfg3, train_config=tc3, use_pallas=True)
        x = torch.rand(256, 784, generator=torch.Generator().manual_seed(14)).cuda()
        want = assoc_mod.cross_generate(saved[-1], x, cfg3, 0, 1)
        err, ok = _max_err(torch.as_tensor(pred.cross_generate(x.cpu().numpy(), 0, 1)).cuda(),
                           want, TOL["float32"])
        assert ok, f"phase 14: the checkpoint's Predictor is {err:.3g} off the trained weights"
        print(f"phase 14: config 3 --use-pallas, 2 epochs x {spe} steps in {secs:.2f} s "
              f"wall, epoch totals {totals}, launches {_nonzero(counts)}; the checkpoint's "
              f"Predictor against the trained weights: max abs err {err:.3g}", flush=True)
        cli_sps = recs[-4]["samples_per_sec"]  # epoch 2's training rate
        ds = PairedDataset.from_synthetic(CLI_ROWS, seed=0, device="cuda")
        _, fused = train_loop_fused(cfg3, tc3, list(ds.features()), epochs=2)
        print(f"phase 14: config 3 composable at batch 64: the CLI's epoch 2 "
              f"{cli_sps / tc3.batch_size:.1f} steps/s against train_loop_fused's "
              f"{fused[-1]['samples_per_sec'] / tc3.batch_size:.1f} ({card})", flush=True)

        secs, counts = counted(c3 + ["--epochs", 3, "--resume", "--ckpt-dir", ck],
                               "config 3 --resume")
        assert ckpt.latest_step(ck) == step3 + 3 * spe, (ckpt.latest_step(ck), step3)
        print(f"phase 14: --resume --epochs 3 went on from step {step3} to "
              f"{ckpt.latest_step(ck)} in {secs:.2f} s wall", flush=True)

        # SIGTERM: a CLI process checkpoints at the next chunk and exits 0.
        ck2 = os.path.join(tmp, "preempt")
        argv = [sys.executable, "-m", "vae_assoc_tpu_torch.train.driver"] + [
            str(a) for a in c3 + ["--epochs", 50, "--preempt-chunk", 1, "--ckpt-dir", ck2]]
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=root, env=dict(os.environ, PYTHONPATH=root),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            for line in proc.stdout:
                if "total=" in line:
                    break
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=180)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, f"phase 14: SIGTERM run exited {proc.returncode}:\n{out}"
        assert "preempted (signal 15): checkpoint saved" in out, out[-2000:]
        step = ckpt.latest_step(ck2)
        assert 0 < step < 50 * spe, step
        counted(c3 + ["--epochs", 1, "--resume", "--ckpt-dir", ck2], "resume after SIGTERM")
        assert ckpt.latest_step(ck2) == step + spe, (ckpt.latest_step(ck2), step)
        print(f"phase 14: SIGTERM after the first epoch: exit 0 with step {step} saved "
              f"({time.perf_counter() - t0:.2f} s wall), --resume went on to step "
              f"{ckpt.latest_step(ck2)}", flush=True)

        # Config 5 (composable, bf16, batch 1024) and config 4 as it ships.
        for name, argv, kernels in (
                ("config 5", ["--config", 5, "--n-samples", CLI_C5_ROWS], COMPOSABLE_PER_STEP),
                ("config 4", ["--config", 4, "--n-samples", CLI_ROWS], SHIPPED_PER_STEP)):
            path = os.path.join(tmp, name.replace(" ", "") + ".jsonl")
            secs, counts = counted(argv + ["--epochs", 2, "--metrics", path], name)
            totals = _cli_totals(read_jsonl(path), name)
            for k in kernels:
                assert counts[k] > 0, f"phase 14: the CLI on {name} launched no {k}"
            print(f"phase 14: {name} as it ships, 2 epochs in {secs:.2f} s wall, epoch "
                  f"totals {totals}, launches {_nonzero(counts)}", flush=True)

        # The sweep: three models, one λ each, on config 3's plain path.
        data = list(ds.features())
        tcs = baseline_config(3)[1]
        ms = os.path.join(tmp, "sweep.jsonl")
        secs = _cli(["--config", 3, "--n-samples", CLI_ROWS, "--epochs", 2, "--metrics", ms,
                     "--sweep-seeds", 3, "--sweep-lambdas"] + list(SWEEP_LAMBDAS), "sweep")
        last = [r for r in read_jsonl(ms) if r.get("epoch") == 1 and "model" in r]
        first = [r for r in read_jsonl(ms) if r.get("epoch") == 0 and "model" in r]
        assert len(last) == len(first) == 3 and all(
            np.isfinite(b["total"]) and b["total"] < a["total"] for a, b in zip(first, last)), \
            (first, last)
        alone = []
        for i, lam in enumerate(SWEEP_LAMBDAS):
            cfg_i = dataclasses.replace(cfg3, assoc_lambda=lam)
            _, h = train_loop(cfg_i, dataclasses.replace(tcs, seed=i), data, epochs=2)
            alone.append(h[-1]["samples_per_sec"])
        print(f"phase 14: --sweep-seeds 3 --sweep-lambdas 0.5 1 2, 2 epochs in {secs:.2f} s "
              f"wall; epoch 2 samples/s a model {[r['samples_per_sec'] for r in last]}, "
              f"in all {last[0]['sweep_model_samples_per_sec']:.1f}; the 3 standalone "
              f"train_loop runs {alone} ({card})", flush=True)
        # Each member's first steps against its standalone run on the same batches.
        state = sweep.init_sweep_state(cfg3, tcs, [0, 1, 2])
        step = sweep.make_sweep_step(cfg3, tcs, vary_assoc=True)
        batches = [[d[s * 64:(s + 1) * 64] for d in data] for s in range(SWEEP_STEPS)]
        lams = torch.tensor(SWEEP_LAMBDAS, device="cuda")
        got = []
        for xs in batches:
            state, m = step(state, xs, lams)
            got.append(m["total"].cpu().numpy())
        worst = 0.0
        for i, lam in enumerate(SWEEP_LAMBDAS):
            cfg_i, tc_i = dataclasses.replace(cfg3, assoc_lambda=lam), dataclasses.replace(
                tcs, seed=i)
            ref, f = init_train_state(cfg_i, tc_i), make_train_step(cfg_i, tc_i)
            for s, xs in enumerate(batches):
                ref, rm = f(ref, xs)
                rel = abs(float(got[s][i]) - float(rm["total"])) / abs(float(rm["total"]))
                worst = max(worst, rel)
        assert worst <= 1e-4, f"phase 14: a sweep member's loss is {worst:.3g} off its own run"
        print(f"phase 14: each member's first {SWEEP_STEPS} step losses against its "
              f"standalone run: largest relative error {worst:.3g}", flush=True)

        # --dry-compile prints the JAX CLI's numbers.
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _cli(["--dry-compile", "--config", 3], "--dry-compile")
        assert "params: 2,049,064 (" in buf.getvalue(), buf.getvalue()
        print("phase 14: --dry-compile --config 3: " + " | ".join(
            buf.getvalue().strip().splitlines()), flush=True)

        # Two gloo ranks sharing the card: --mesh 2 --zero on config 5.
        t0 = time.perf_counter()
        ranks = spawn(_cli_zero_worker, 2, (tmp,), backend="gloo", timeout_s=300)
        assert [r["rc"] for r in ranks] == [0, 0] and ranks[0]["backend"] == "gloo", ranks
        for a, b in zip(ranks[0]["weights"], ranks[1]["weights"]):
            assert np.array_equal(a, b), "phase 14: the --zero ranks' weights differ"
        zt = [r["total"] for r in read_jsonl(os.path.join(tmp, "zero.jsonl"))
              if "samples_per_sec" in r]
        assert len(zt) == 1 and np.isfinite(zt[0]), zt
        print(f"phase 14: --mesh 2 --zero on config 5, two gloo ranks on the card: exit 0 on "
              f"both, the same weights, epoch total {zt[0]:.3f} "
              f"({time.perf_counter() - t0:.2f} s wall)", flush=True)
        t0 = time.perf_counter()
        legs = graft_entry.dryrun_multichip(4, backend="gloo", timeout_s=300)
        assert legs == list(graft_entry.LEGS), legs
        print(f"phase 14: graft_entry.dryrun_multichip(4, backend='gloo'): legs {legs} in "
              f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 14: CLI launches {_nonzero(launches)}", flush=True)
    print(f"phase 14 took {time.perf_counter() - t_phase:.2f} s wall", flush=True)
    return launches


# Sketch-RNN's sizes in the cell sk-train-rnn-bf16-b100 (get_default_hparams).
SKETCH_BATCH, SKETCH_STEPS, SKETCH_ENC, SKETCH_DEC, SKETCH_MIX = 100, 250, 256, 512, 20
SKETCH_PER_STEP = {"lstm_fwd": 2, "lstm_bwd": 2, "mixture_loss": 1}
"""Sketch launches per training step: one persistent launch a layer forward
for the encoder (both directions in one) and the decoder; backward the same
(the decoder's launch ends with its initial state's step, which z gives);
one mixture loss."""
MIX_TOL = {"loss": (1e-5, 1e-5), "dy": (1e-4, 1e-5)}  # (rtol, atol): exp/log ulps, sum order


def _sketch_points(n, g):
    """Stroke-5 targets of n sketches as the cell draws them: lengths
    uniform on 64..250, offsets N(0, 1), the pen lifted at 1 point in 10,
    padding (0, 0, 0, 0, 1); [n, 250, 5] on the card."""
    t = SKETCH_STEPS
    length = torch.randint(64, t + 1, (n, 1), generator=g, device="cuda")
    lift = (torch.rand(n, t, 1, generator=g, device="cuda") < 0.1).float()
    pts = torch.cat([torch.randn(n, t, 2, generator=g, device="cuda"), 1 - lift, lift,
                     torch.zeros_like(lift)], dim=2)
    pad = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0], device="cuda")
    return torch.where((torch.arange(t, device="cuda") >= length)[..., None], pad, pts)


def _lstm_layer(n_dirs, hidden, g, swap=False):
    """The directions of one LSTM layer at the cell's batch and steps, from
    the generator's draws (the same draws give the same inputs): hoisted
    products, W_h (its i and f gate blocks swapped with ``swap``), initial
    states, the cotangent of every state, and zeroed backward buffers."""
    from vae_assoc_tpu_torch.kernels import lstm as klstm

    t, b = SKETCH_STEPS, SKETCH_BATCH
    dirs = []
    for _ in range(n_dirs):
        xp = torch.randn(t, b, 4 * hidden, generator=g, device="cuda") * 0.5
        w = torch.randn(hidden, 4 * hidden, generator=g, device="cuda") / hidden ** 0.5
        if swap:
            w = torch.cat([w[:, 2 * hidden:3 * hidden], w[:, hidden:2 * hidden],
                           w[:, :hidden], w[:, 3 * hidden:]], dim=1)
        hs = torch.empty(t + 1, b, hidden, device="cuda")
        cs = torch.empty_like(hs)
        hs[0] = torch.randn(b, hidden, generator=g, device="cuda") * 0.5
        cs[0] = torch.randn(b, hidden, generator=g, device="cuda") * 0.5
        d = klstm.Direction(xp, w.contiguous(), hs, cs, torch.empty(t, b, 4 * hidden,
                                                                      device="cuda"))
        d.dh_seq = torch.randn(t + 1, b, hidden, generator=g, device="cuda")
        d.dgates = torch.zeros(t + 1, b, 4 * hidden, device="cuda")
        d.dh_acc, d.dc_acc, d.dh0 = (torch.zeros(b, hidden, device="cuda") for _ in range(3))
        dirs.append(d)
    return dirs


def _lstm_forward(dirs, xrow, lengths, cd, plain):
    """Every step forward: lstm_fwd, or its twin a step at a time."""
    from vae_assoc_tpu_torch.kernels import lstm as klstm

    if not plain:
        return klstm.run_forward(dirs, xrow, lengths, cd)
    for t in range(SKETCH_STEPS):
        klstm.lstm_fwd_plain(dirs, xrow, lengths, t, cd)


def _lstm_backward(dirs, lengths, cd, plain):
    """Every step backward and the initial state's launch, from zeroed
    carries: lstm_bwd, or its twin a step at a time."""
    from vae_assoc_tpu_torch.kernels import lstm as klstm

    for d in dirs:
        d.dh_acc.zero_()
        d.dc_acc.zero_()
    if not plain:
        return klstm.run_backward(dirs, lengths, cd, initial=True)
    for t in range(SKETCH_STEPS - 1, -2, -1):
        klstm.lstm_bwd_plain(dirs, lengths, t, SKETCH_STEPS, cd)


def _lstm_work(n_dirs, hidden, fwd):
    """(bytes, operations) of one layer's launches over every step: per
    direction, the recurrent product (the input product is hoisted out) and
    W_h read once; forward the hoisted products read and the gate
    pre-activations, h and c written; backward the pre-activations, c and
    the states' cotangents read and the gate gradients written (the same
    bytes)."""
    t, b = SKETCH_STEPS, SKETCH_BATCH
    flops = n_dirs * 2 * b * (t if fwd else t + 1) * hidden * 4 * hidden
    moved = 2 * t * b * 4 * hidden + 2 * t * b * hidden
    return n_dirs * 4 * (hidden * 4 * hidden + moved), flops


def _barrier_us(per_group, groups):
    """The kernels' step barrier alone (csrc/lstm.cu::lstm_sync_probe) over
    ``groups`` groups of ``per_group`` blocks: µs a step, from the CUDA-event
    times of 2,000 and 22,000 steps (the launch cancels)."""
    from vae_assoc_tpu_torch.kernels import _build
    from vae_assoc_tpu_torch.kernels import lstm as klstm

    lib = _build.load()
    sync = klstm.sync_counters(torch.device("cuda"))
    stream = torch.cuda.current_stream().cuda_stream

    def run(steps):
        err = lib.vae_lstm_sync_probe(sync.data_ptr(), klstm.SYNC_GROUPS, groups, per_group,
                                      steps, stream)
        _build.check(lib, err, "lstm_sync_probe launch")

    run(100)
    ms = {}
    for steps in (2000, 22000, 2000, 22000):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run(steps)
        b.record()
        torch.cuda.synchronize()
        ms.setdefault(steps, []).append(a.elapsed_time(b))
    return 1e3 * (min(ms[22000]) - min(ms[2000])) / 20000


def _mixture_work(rows, m=SKETCH_MIX):
    """(bytes, operations) of mixture_loss: the head output and targets read
    once, the gradient and the loss written once; its ≈ 50 operations a
    component and row (exp, log, tanh among them) stay far under the
    bytes' time, so they are left out."""
    width = 3 + 6 * m
    return 4 * rows * (2 * width + 5 + 1), 0


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def sketch_kernels_and_check(card):
    """Phase 15; returns the three kernels' rows of the kernel record."""
    from vae_assoc_tpu_torch.configs import AssocConfig, ModalityConfig, TrainConfig
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.kernels import lstm as klstm
    from vae_assoc_tpu_torch.kernels import mixture as kmix
    from vae_assoc_tpu_torch.train import init_train_state, train_loop_fused
    from vae_assoc_tpu_torch.train.loop import GRAPH

    rows = {k: {"name": k, "route": "cuda", "replaces": "none: the JAX package has no "
                "recurrent tower"} for k in SKETCH_PER_STEP}
    rows["lstm_fwd"]["source"] = rows["lstm_bwd"]["source"] = CSRC + "lstm.cu"
    rows["mixture_loss"]["source"] = CSRC + "mixture.cu"
    layers = {"encoder": (2, SKETCH_ENC), "decoder": (1, SKETCH_DEC)}
    failed = []
    for cd in ("float32", "bfloat16"):
        for name, (n_dirs, hidden) in layers.items():
            for kernel in ("lstm_fwd", "lstm_bwd"):
                split = klstm.step_plan(kernel == "lstm_fwd", SKETCH_BATCH, hidden, n_dirs, cd,
                                        torch.device("cuda"))
                print(f"{kernel} {name} ({n_dirs} x {hidden} units) {cd} split: {split}",
                      flush=True)
                if split["launches"] != 1:
                    failed.append(f"{kernel} {name} {cd}: {split['launches']} launches a call")
    barrier = {f"{groups} x {per}": _barrier_us(per, groups)
               for groups, per in ((4, 32), (1, 32), (8, 16))}
    print(f"lstm step barrier alone (groups x blocks): "
          + ", ".join(f"{k} {v:.3f} us a step" for k, v in barrier.items()), flush=True)
    for cd in ("float32", "bfloat16"):
        tol = TOL[cd]
        errs = {"lstm_fwd": 0.0, "lstm_bwd": 0.0}
        times = {}
        for name, (n_dirs, hidden) in layers.items():
            g = torch.Generator(device="cuda")
            g.manual_seed(15)
            lengths = (torch.randint(64, SKETCH_STEPS + 1, (SKETCH_BATCH,), generator=g,
                                     device="cuda").int() if n_dirs == 2 else None)
            xrow = (torch.randn(SKETCH_BATCH, 4 * hidden, generator=g, device="cuda") * 0.3
                    if n_dirs == 1 else None)
            state = g.get_state()
            runs = {}
            for which, plain, swap in (("kernel", False, False), ("plain", True, False),
                                       ("swapped", True, True)):
                g.set_state(state)
                dirs = _lstm_layer(n_dirs, hidden, g, swap)
                _lstm_forward(dirs, xrow, lengths, cd, plain)
                _lstm_backward(dirs, lengths, cd, plain)
                runs[which] = dirs
            torch.cuda.synchronize()
            fwd = {"hs": lambda d: d.hs, "cs": lambda d: d.cs, "gates": lambda d: d.gates}
            bwd = {"dgates": lambda d: d.dgates[:SKETCH_STEPS], "dh0": lambda d: d.dh0,
                   "dc0": lambda d: d.dc_acc}
            for kernel, parts in (("lstm_fwd", fwd), ("lstm_bwd", bwd)):
                got = {p: max(_rel_err(f(k), f(w)) for k, w in zip(runs["kernel"],
                                                                    runs["plain"]))
                       for p, f in parts.items()}
                errs[kernel] = max(errs[kernel], *got.values())
                print(f"{kernel} {name} ({n_dirs} x {hidden} units) {cd}, kernel vs twin, "
                      f"max err over max|want|: " + ", ".join(f"{p} {e:.3e}" for p, e in
                                                               got.items())
                      + f" (tol {tol})", flush=True)
                if max(got.values()) > tol:
                    failed.append(f"{kernel} {name} {cd}: {got}")
            swapped = _rel_err(runs["swapped"][0].hs, runs["plain"][0].hs)
            print(f"lstm twin with the i and f gates swapped, {name} {cd}: hs err {swapped:.3e} "
                  f"(must exceed {tol})", flush=True)
            if swapped <= tol:
                failed.append(f"a wrong gate order passes the {name} {cd} tolerance")
            dirs = runs["kernel"]
            for kernel, fns, work in (
                    ("lstm_fwd", {"kernel": lambda: _lstm_forward(dirs, xrow, lengths, cd, False),
                                  "plain": lambda: _lstm_forward(dirs, xrow, lengths, cd, True)},
                     _lstm_work(n_dirs, hidden, True)),
                    ("lstm_bwd", {"kernel": lambda: _lstm_backward(dirs, lengths, cd, False),
                                  "plain": lambda: _lstm_backward(dirs, lengths, cd, True)},
                     _lstm_work(n_dirs, hidden, False))):
                bound = _bound(*work, cd)
                timed = _time_case(f"{kernel} {name} {cd}, all {SKETCH_STEPS} steps", fns, card,
                                   bound=bound, n=3)
                times[(kernel, name)] = (timed, bound)
        for kernel in ("lstm_fwd", "lstm_bwd"):
            ms = {w: sum(times[(kernel, n)][0]["call"][w] for n in layers)
                  for w in ("kernel", "plain")}
            bound_ms = sum(times[(kernel, n)][1][0] for n in layers)
            out = {"max_abs_err": errs[kernel], "ms": ms["kernel"], "plain_ms": ms["plain"],
                   "bound_ms": bound_ms, "bound_by": times[(kernel, "encoder")][1][1],
                   "layer_ms": {n: times[(kernel, n)][0]["call"]["kernel"] for n in layers},
                   "shape": "a training step's encoder and decoder layers, CUDA events"}
            if cd == "float32":
                rows[kernel].update(out)
            else:
                rows[kernel]["bf16"] = out

    # mixture_loss on a training step's 25,000 head rows (fp32 in every dtype).
    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    n = SKETCH_BATCH * SKETCH_STEPS
    y = torch.randn(n, 3 + 6 * SKETCH_MIX, generator=g, device="cuda") * 0.5
    tgt = _sketch_points(SKETCH_BATCH, g).reshape(n, 5)
    loss, dy = kmix.mixture_loss_kernel(y, tgt)
    want, dwant = kmix.mixture_loss_plain(y, tgt)
    m = SKETCH_MIX
    ys = torch.cat([y[:, :3 + m], y[:, 3 + 2 * m:3 + 3 * m], y[:, 3 + m:3 + 2 * m],
                    y[:, 3 + 3 * m:]], dim=1)
    swapped = kmix.mixture_loss_plain(ys, tgt)[0]
    worst = {}
    for part, got, ref in (("loss", loss, want), ("dy", dy, dwant), ("swapped", swapped, want)):
        rtol, atol = MIX_TOL["loss" if part == "swapped" else part]
        worst[part] = float(((got - ref).abs() - rtol * ref.abs()).max())
        print(f"mixture_loss {part} vs twin: max(|err| - rtol|want|) {worst[part]:.3e} "
              f"(atol {atol}{', must exceed' if part == 'swapped' else ''})", flush=True)
    if worst["loss"] > MIX_TOL["loss"][1] or worst["dy"] > MIX_TOL["dy"][1]:
        failed.append(f"mixture_loss vs twin: {worst}")
    if worst["swapped"] <= MIX_TOL["loss"][1]:
        failed.append("swapped means pass the mixture tolerance")
    bound = _bound(*_mixture_work(n))
    timed = _time_case(f"mixture_loss {n} rows", {
        "kernel": lambda: kmix.mixture_loss_kernel(y, tgt),
        "plain": lambda: kmix.mixture_loss_plain(y, tgt)}, card, bound=bound)
    rows["mixture_loss"].update(
        max_abs_err=float((loss - want).abs().max()), ms=timed["call"]["kernel"],
        plain_ms=timed["call"]["plain"], bound_ms=bound[0], bound_by=bound[1],
        shape=f"{n} x {3 + 6 * m} head rows, CUDA events")

    # The cell's model through train_loop_fused: launches a step from the run itself.
    image = ModalityConfig("image", dict(n_input=784, n_z=128, n_hidden_recog_1=500,
                                         n_hidden_recog_2=500, n_hidden_gener_1=500,
                                         n_hidden_gener_2=500), recon="bernoulli")
    sketch = ModalityConfig("sketch", dict(n_input=5, n_z=128, max_seq_len=SKETCH_STEPS,
                                           enc_rnn_size=SKETCH_ENC, dec_rnn_size=SKETCH_DEC,
                                           num_mixture=SKETCH_MIX),
                            recon="mixture", encoder="sketch_rnn", kl_tolerance=0.2,
                            kl_weight=0.5, kl_weight_start=0.01, kl_decay_rate=0.99995)
    cfg = AssocConfig([image, sketch], assoc_lambda=1.0)
    tc = TrainConfig(batch_size=SKETCH_BATCH, compute_dtype="bfloat16", use_pallas=True,
                     steps_per_call=1, lr_schedule="exponential", lr_decay_rate=0.9999,
                     min_learning_rate=1e-5, grad_clip_value=1.0, seed=15)
    steps = 4
    g.manual_seed(17)
    start = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0], device="cuda").expand(
        steps * SKETCH_BATCH, 1, 5)
    data = [torch.rand(steps * SKETCH_BATCH, 784, generator=g, device="cuda"),
            torch.cat([start, _sketch_points(steps * SKETCH_BATCH, g)], dim=1)]
    state = init_train_state(cfg, tc, device="cuda")
    g0 = dict(GRAPH)
    reset_launches()
    state, hist = train_loop_fused(cfg, tc, data, epochs=1, state=state)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if k in SKETCH_PER_STEP}
    g1 = dict(GRAPH)
    graph = {k: g1[k] - g0[k] for k in g0}
    print(f"sketch training, {state.step} steps of batch {SKETCH_BATCH}: launches {launches}, "
          f"graph {graph}, total {hist[0]['total']:.4f}", flush=True)
    if launches != {k: v * steps for k, v in SKETCH_PER_STEP.items()}:
        failed.append(f"sketch training launches {launches}")
    if state.step != steps or not np.isfinite(hist[0]["total"]) or graph["captures"] != 1:
        failed.append(f"sketch training: {state.step} steps, {hist}, graph {graph}")
    for k in rows:
        rows[k]["launches"] = launches[k]
    rows["lstm_fwd"]["barrier_us"] = barrier
    assert not failed, "; ".join(failed)
    return list(rows.values())


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
    build_s = time.perf_counter() - t0
    print(f"built {lib_path.name} in {build_s:.2f} s", flush=True)
    print((lib_path.parent / "build.log").read_text().strip(), flush=True)
    if sys.argv[1:] == ["--only", "sketch"]:
        # Phase 15 alone
        print(json.dumps({"kernels": sketch_kernels_and_check(card)}), flush=True)
        return _ok()
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; takes none or --only sketch",
              file=sys.stderr)
        return 2

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

    # Phase 11
    export_launches, floor = export_and_check(rng, card, pred, plain, lib_path, build_s)

    # Phase 12
    parallel_launches = parallel_check(card)
    # Phase 13
    for k, v in layouts_check(card).items():
        parallel_launches[k] = parallel_launches.get(k, 0) + v

    # Phase 14
    cli_launches = cli_check(card)

    # Phase 15
    sketch_rows = sketch_kernels_and_check(card)

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
            # launches by phase 11's kernel-path Predictors (the artifacts launch none)
            "export_launches": export_launches.get(name, 0),
            # launches by phases 12 and 13's parallel layouts at world size 1
            "parallel_launches": parallel_launches.get(name, 0),
            # launches by phase 14's in-process runs of the training CLI
            "cli_launches": cli_launches.get(name, 0),
        }
        if name == "reparam":  # an empty kernel's launch, timed as this row and queued
            row["floor_ms"] = ms(floor[small], "floor")
            row["queued_ms"] = floor[small]["queued"]["kernel"]
            row["floor_queued_ms"] = floor[small]["queued"]["floor"]
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
    print(json.dumps({"kernels": kernels + sketch_rows}), flush=True)
    return _ok()


def _ok() -> int:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
