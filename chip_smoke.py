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
   activations between layers may flip).
4. Serving, the port's main path: baseline config 3 at full width with
   random weights from seed 0, a Predictor on the fused kernels behind
   ModelServer, every HTTP route, 16 concurrent requests; outputs checked
   for shape, finiteness and range, and against the same model served on
   the plain path. The kernels' launch counts are reset just before the
   requests and must both be positive after them.
5. Times: Predictor.cross_generate image→trajectory p50/p95 per bucket for
   both paths, and each tower's device time (CUDA events) against its plain
   twin.
6. The training kernels against their plain twins on the card: the tower
   forward (injected and seeded ε), the decoder+loss backward, the encoder
   backward and the weight-gradient kernel, for the config-3 towers and a
   conditional image tower (n_cond=10), batches 1 to 16384, fp32
   (rtol = atol = 1e-4) and bf16 (2e-2); a gradient summed over the batch
   takes atol = tol × max|want|.
7. Training, the port's second main path: config 3 at full width from
   seed 0, trained through train_loop on the kernels (use_pallas="mega")
   and on the plain path. Step-0 gradients agree within phase 6's
   tolerances, the per-step total over 20 steps within rtol 1e-3, the loss
   falls over 200 steps, and the training kernels' launch counts are reset
   just before the kernel-path run and must all be positive after it.
8. Times: train_loop_fused samples/s on both paths, interleaved
   plain–kernel–kernel–plain, at batch 16384 bf16 (steps_per_call=4) and
   batch 64 fp32 on 65,536 synthetic pairs featurized on the card; and the
   device ms per launch of each training kernel against its twin.

The line before the last is the kernel record as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

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
TRAIN_BATCHES = (1, 7, 64, 257, 4096, 16383, 16384)
TRAIN_TIMED = (1024, 16384)
CSRC = "vae_assoc_tpu_torch/kernels/csrc/"


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
                        want = kmlp.encode_mlp_plain(m, x, compute_dtype=cd)
                    else:
                        z = torch.from_numpy(rng.normal(
                            size=(b, arch["n_z"] + n_cond)).astype(np.float32)).cuda()
                        got = (kmlp.decode_mlp_fused(m, z, compute_dtype=cd),)
                        want = (kmlp.decode_mlp_plain(m, z, compute_dtype=cd),)
                    torch.cuda.synchronize()
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

    def record(key, pairs, tol):
        worst = 0.0
        for name, got, want, summed in pairs:
            err, ok = _close(got, want, tol, summed)
            worst = max(worst, err)
            if not ok:
                failed.append(f"{key} {name} err={err:.3e}")
        errs[key] = worst
        return worst

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
                torch.cuda.synchronize()
                line["mega_fwd"].append(record(
                    ("mega_fwd", tower, b, cd),
                    [(n, g, w, False) for n, g, w in zip(names, got, want)], tol))
                seed = 1000 + b
                got = km.tower_fwd(flat, x, kind=kind, seed=seed, compute_dtype=cd)
                want = km.tower_fwd_plain(flat, x, philox_normal(seed, b, n_z, "cuda"),
                                          kind=kind, compute_dtype=cd)
                torch.cuda.synchronize()
                line["mega_fwd_seeded"].append(record(
                    ("mega_fwd_seeded", tower, b, cd),
                    [(n, g, w, False) for n, g, w in zip(names, got, want)], tol))
                mu, lv = want[0], want[1]
                z = mu + torch.exp(0.5 * lv) * want[2]
                grec = torch.from_numpy(rng.uniform(0.5, 1.5, b).astype(np.float32)).cuda() / b
                got = km.dec_loss_bwd(x, z, flat[8:], grec, kind=kind, compute_dtype=cd)
                want = km.dec_loss_bwd_plain(x, z, flat[8:], grec, kind=kind, compute_dtype=cd)
                torch.cuda.synchronize()
                pairs = [("dz", got[0], want[0], False)]
                pairs += [(f"grad{i}", g, w, True) for i, (g, w) in enumerate(zip(got[1], want[1]))]
                line["mega_dec_loss_bwd"].append(record(("mega_dec_loss_bwd", tower, b, cd), pairs, tol))
                dmu = torch.from_numpy(rng.normal(size=(b, n_z)).astype(np.float32)).cuda() / b
                dlv = torch.from_numpy(rng.normal(size=(b, n_z)).astype(np.float32)).cuda() / b
                layers = kmlp._pairs(flat[:8])
                got = kmlp.encode_bwd(layers[:2], layers[2:], x, dmu, dlv, compute_dtype=cd)
                want = kmlp.encode_bwd_plain(layers[:2], layers[2:], x, dmu, dlv, compute_dtype=cd)
                torch.cuda.synchronize()
                pairs = [("dx", got[1], want[1], False)]
                for i, (g, w) in enumerate(zip(got[0], want[0])):
                    pairs += [(f"dw{i}", g[0], w[0], True), (f"db{i}", g[1], w[1], True)]
                line["enc_bwd"].append(record(("enc_bwd", tower, b, cd), pairs, tol))
                a = torch.from_numpy(rng.uniform(0, 1, (b, 500)).astype(np.float32)).cuda()
                d = torch.from_numpy(rng.normal(size=(b, n_x)).astype(np.float32)).cuda()
                got = kmlp.weight_grads(a, d, compute_dtype=cd)
                want = kmlp.weight_grads_plain(a, d, compute_dtype=cd)
                torch.cuda.synchronize()
                line["wgrad"].append(record(
                    ("wgrad", tower, b, cd),
                    [("dw", got[0], want[0], True), ("db", got[1], want[1], True)], tol))
            for k, v in line.items():
                print(f"check {tower} {k} {cd} (tol {tol}): " + " ".join(
                    f"B={b}:{e:.2e}" for b, e in zip(batches, v)), flush=True)
    if failed:
        raise AssertionError("training kernel disagrees with its plain twin: "
                             + "; ".join(failed[:20]))
    return errs


def train_and_check(card):
    """Phase 7; returns the training kernels' launch counts of the main path
    and its per-step totals."""
    import dataclasses

    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.kernels import launch_counts, reset_launches
    from vae_assoc_tpu_torch.kernels import mlp as kmlp
    from vae_assoc_tpu_torch.models import assoc as assoc_mod
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
    worst, bad = 0.0, []
    for (key, _), g, w in zip(model.named_parameters(), grads["kernel"], grads["plain"]):
        err, ok = _close(g, w, tol, summed=True)
        worst = max(worst, err)
        if not ok:
            bad.append(f"{key} err={err:.3e}")
    print(f"step-0 grads, kernel vs plain path: {len(grads['plain'])} tensors, max abs "
          f"err {worst:.3e} (rtol {tol}, atol {tol} x max|want|)", flush=True)
    assert not bad, "step-0 grads disagree: " + "; ".join(bad)
    try:
        kmlp.decode_mlp_fused(model.modalities[0], torch.zeros(2, 20, device="cuda"))
    except NotImplementedError:
        pass
    else:
        raise AssertionError("decode_mlp_fused ran under autograd without a backward kernel")

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


def time_training(card):
    """Phase 8a: train_loop_fused samples/s, kernel vs plain path, in turns."""
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
    return rates


def time_train_kernels(rng, card):
    """Phase 8b: device ms per launch of each training kernel (its wrapper,
    weight-gradient launches included) against its twin, image tower."""
    from vae_assoc_tpu_torch.kernels import megakernel as km
    from vae_assoc_tpu_torch.kernels import mlp as kmlp
    from vae_assoc_tpu_torch.models.networks import init_mlp_vae_params

    arch, n_cond, kind = train_archs()["image"]
    m = init_mlp_vae_params(torch.Generator().manual_seed(2), arch, device="cuda")
    flat = [t.detach() for t in km.flatten(m)]
    layers = kmlp._pairs(flat[:8])
    times = {}
    with torch.no_grad():
        for cd in TOL:
            for b in TRAIN_TIMED:
                def t(*shape):
                    return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).cuda()
                x, eps, g = t(b, 784), t(b, 20), t(b) / b
                z, dmu, dlv, a, d = t(b, 20), t(b, 20) / b, t(b, 20) / b, t(b, 500), t(b, 784)
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
                }
                for name, (kern, plain) in cases.items():
                    for _ in range(2):
                        kern()
                        plain()
                    runs = {"kernel": [], "plain": []}
                    for which in ("plain", "kernel", "kernel", "plain"):
                        fn = kern if which == "kernel" else plain
                        runs[which].append(_device_ms(fn, n=10))
                    kt, pt = float(np.mean(runs["kernel"])), float(np.mean(runs["plain"]))
                    times[(name, b, cd)] = (kt, pt)
                    print(f"device time {name} image B={b} {cd}: kernel {kt:.4f} ms, plain "
                          f"{pt:.4f} ms, plain/kernel {pt / kt:.3f} [{card}]", flush=True)
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
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched by the serving path"

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


def time_serving(pred, plain, rng, card):
    """Phase 5a: host-clock latency of Predictor.cross_generate (each call
    ends in a device-to-host copy, so it waits for the device)."""
    for b in BUCKETS:
        x = rng.uniform(0, 1, (b, 784)).astype(np.float32)
        for p in (pred, plain):
            for _ in range(3):
                p.cross_generate(x, "image", "trajectory")
        samples = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            p = pred if name == "kernel" else plain
            samples[name] += _pcts(lambda: p.cross_generate(x, "image", "trajectory"), 25)
        k, q = np.array(samples["kernel"]), np.array(samples["plain"])
        print(f"latency cross_generate image->trajectory bucket={b}: kernel "
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
    against plain twin, in turns (plain, kernel, kernel, plain)."""
    from vae_assoc_tpu_torch.kernels import mlp as kmlp

    img, traj = model.modalities
    stacks = {
        "image_enc": (kmlp.encode_mlp_fused, kmlp.encode_mlp_plain, img, 784),
        "trajectory_enc": (kmlp.encode_mlp_fused, kmlp.encode_mlp_plain, traj, 200),
        "image_dec": (kmlp.decode_mlp_fused, kmlp.decode_mlp_plain, img, 20),
        "trajectory_dec": (kmlp.decode_mlp_fused, kmlp.decode_mlp_plain, traj, 20),
    }
    times = {}
    with torch.inference_mode():
        for b in BUCKETS:
            for name, (fused, plain, m, width) in stacks.items():
                x = torch.from_numpy(rng.uniform(0, 1, (b, width)).astype(np.float32)).cuda()
                runs = {"kernel": [], "plain": []}
                for _ in range(3):
                    fused(m, x, compute_dtype=cd)
                    plain(m, x, compute_dtype=cd)
                for which in ("plain", "kernel", "kernel", "plain"):
                    fn = fused if which == "kernel" else plain
                    runs[which].append(_device_ms(lambda: fn(m, x, compute_dtype=cd)))
                k, p = float(np.mean(runs["kernel"])), float(np.mean(runs["plain"]))
                times[(name, b)] = (k, p)
                print(f"device time {name} B={b} {cd}: kernel {k:.4f} ms, plain "
                      f"{p:.4f} ms, plain/kernel {p / k:.3f} [{card}]", flush=True)
    return times


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

    # Phase 5
    time_serving(pred, plain, rng, card)
    times = time_kernels(pred.params, pred.compute_dtype, rng, card)

    # Phase 6
    train_errs = check_train_kernels(rng)

    # Phase 7
    train_launches = train_and_check(card)

    # Phase 8
    time_training(card)
    train_times = time_train_kernels(rng, card)

    cd = pred.compute_dtype
    big = TRAIN_TIMED[-1]
    train_rows = [
        ("mega_fwd", "mega.cu", "vae_assoc_tpu/kernels/megakernel.py:192"),
        ("mega_dec_loss_bwd", "mega.cu", "vae_assoc_tpu/kernels/megakernel.py:240"),
        ("enc_bwd", "mlp_bwd.cu", "vae_assoc_tpu/kernels/mlp.py:309"),
        ("wgrad", "mlp_bwd.cu", "vae_assoc_tpu/kernels/mlp.py:285"),
    ]
    record = {"kernels": [
        {"name": "enc_fwd", "route": "cuda", "source": SOURCE,
         "replaces": "vae_assoc_tpu/kernels/mlp.py:299",
         "launches": launches["enc_fwd"],
         "max_abs_err": errs[("image_enc", TIMED_BATCH, cd)],
         "ms": times[("image_enc", TIMED_BATCH)][0],
         "plain_ms": times[("image_enc", TIMED_BATCH)][1]},
        {"name": "dec_fwd", "route": "cuda", "source": SOURCE,
         "replaces": "vae_assoc_tpu/kernels/mlp.py:486",
         "launches": launches["dec_fwd"],
         "max_abs_err": errs[("trajectory_dec", TIMED_BATCH, cd)],
         "ms": times[("trajectory_dec", TIMED_BATCH)][0],
         "plain_ms": times[("trajectory_dec", TIMED_BATCH)][1]},
    ] + [
        {"name": name, "route": "cuda", "source": CSRC + src, "replaces": replaces,
         "launches": train_launches[name],
         "max_abs_err": train_errs[(name, "image", big, "float32")],
         "ms": train_times[(name, big, "float32")][0],
         "plain_ms": train_times[(name, big, "float32")][1]}
        for name, src, replaces in train_rows
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
