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

    cd = pred.compute_dtype
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
