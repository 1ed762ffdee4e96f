"""Time the port's hand-written kernels and training steps for one or more
checkouts of the port on one CUDA card, in turns.

    python3 vae_assoc_tpu_torch/tools/time_checkouts.py ROOT [ROOT ...]

Each ROOT is a directory holding a ``vae_assoc_tpu_torch`` package (this
repository, or an older commit unpacked with ``git archive``). The roots'
kernels are built first, all at once, each in a process of its own. Then
the rounds run the roots in order and then in reverse (A, B, B, A), each
in a process of its own that imports that root's package. A round times,
with CUDA events over 50 calls after 2 warm-up calls (at the small
buckets the events read the host's time per call, which moves from call
to call), in fp32 and bf16:

- at B = 1024 and 16384: ``conv_enc`` and ``conv_dec``
  (``kernels/conv_mega.py`` on a config-4 tower, random weights from seed
  5, Bernoulli loss); ``mega_fwd`` (``kernels/megakernel.py::tower_fwd``
  on config 3's image tower, random weights from seed 2, injected ε) and
  ``mega_dec_loss_bwd`` on its decoder, once as the wrapper runs it (the
  kernel and its three ``wgrad`` launches) and once alone (the wrapper
  with ``kernels/mlp.weight_grads`` replaced by a function that launches
  nothing); ``enc_bwd`` and ``dec_bwd`` (``kernels/mlp.py``'s
  ``encode_bwd`` and ``decode_bwd`` on the image encoder and decoder) with
  their ``wgrad`` launches, alone in the same way, and, where the
  checkout's wrappers take ``want_dx``, with their ``wgrad`` launches but
  without the input gradient (``nodx``);
- at the serving buckets 1, 64, 256, 1024 and 4096 and at B = 16384: the
  stack forward, ``enc_fwd`` (``encode_mlp_fused`` on the image encoder)
  and ``dec_fwd`` (``decode_mlp_fused`` on the trajectory and the image
  decoders; config 3's trajectory tower from seed 2), also on the host's
  clock without a wait (``host``: what a call costs the host to enqueue);

and each case's device busy time per call, the CUDA kernels' own time that
torch.profiler records over 10 calls (None where it recorded fewer kernels
than calls), which leaves out the device waiting for the host. Then it
reads ``train_loop_fused``'s samples/s on 65,536 synthetic pairs
featurized on the card (after one warm-up run each): config 3 on the mega
path at batch 16384 bf16 (steps_per_call=4, 4 epochs) and config 5's
settings (batch 1024 bf16) on the composable, mega and plain paths (2
epochs each), config 4 as it ships at batch 64 fp32 on 4096 pairs, and
config 4's on the plain path (``use_pallas=False``, plain ``F.conv2d`` on
the image tower) at batch 64 fp32 on 4096 pairs and batch 2048 bf16 on
16384 (1 epoch each); and whether config 4's steps repeat their bits
(:func:`conv_plain_bits`: 1 if they do, else 0). It
prints one line per (root, round, case) and, as its last line, a JSON
object of the means per root with the card's name and power limit. Exits
non-zero without a CUDA card.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys

BATCHES = (1024, 16384)
STACK_BATCHES = (1, 64, 256, 1024, 4096, 16384)
DTYPES = ("float32", "bfloat16")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _events_ms(fn, n=50):
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _host_ms(fn, n=50):
    """Host ms per call to enqueue ``fn`` (the wrapper's Python, checks,
    allocation and launch), with no wait for the device inside."""
    import time

    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def _busy_ms(fn, n=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import torch

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in device)
    return us / n / 1e3 if us > 0 and sum(e.count for e in device) >= n else None


def conv_plain_bits(steps: int = 5) -> dict:
    """Config 4 (batch 64 fp32) as it ships (``"mega"``: plain convs on the
    image tower, the megakernel on the trajectory tower) and on the plain
    path: ``steps`` train_loop steps from two copies of one
    ``init_train_state``, in this process. Returns {path: (identical bits
    in every parameter and every step's total, the totals of each copy)}."""
    import copy
    import dataclasses

    import torch

    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.train import init_train_state, train_loop

    cfg, tc = baseline_config(4)
    batch = list(PairedDataset.from_synthetic(tc.batch_size, seed=0, device="cuda").features())
    out = {}
    for path, up in (("shipped", tc.use_pallas), ("plain", False)):
        t = dataclasses.replace(tc, use_pallas=up, steps_per_call=1)
        state = init_train_state(cfg, t, device="cuda")
        runs = []
        for _ in range(2):
            s, h = train_loop(cfg, t, batch, epochs=steps, state=copy.deepcopy(state))
            runs.append((list(s.params.parameters()), [e["total"] for e in h]))
        (p1, t1), (p2, t2) = runs
        same = t1 == t2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
        out[path] = (same, t1, t2)
    return out


def _train_rates() -> dict:
    """train_loop_fused samples/s: config 3 mega at batch 16384 bf16,
    config 5's settings on its three paths, config 4 as shipped and plain;
    and whether config 4's steps repeat their bits."""
    import dataclasses

    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.data import PairedDataset
    from vae_assoc_tpu_torch.train import train_loop_fused

    data = list(PairedDataset.from_synthetic(65536, seed=0, device="cuda").features())
    cfg3, tc3 = baseline_config(3)
    cfg5, tc5 = baseline_config(5)
    cfg4, tc4 = baseline_config(4)
    runs = {  # name: (cfg, tc, epochs, rows)
        "config 3 mega batch 16384 bf16": (cfg3, dataclasses.replace(
            tc3, use_pallas="mega", batch_size=16384, compute_dtype="bfloat16",
            steps_per_call=4), 4, 65536),
        **{f"config 5 {name}": (cfg5, dataclasses.replace(tc5, use_pallas=up), 2, 65536)
           for name, up in (("composable", True), ("mega", "mega"), ("plain", False))},
        "config 4 shipped batch 64 fp32": (cfg4, dataclasses.replace(
            tc4, batch_size=64, compute_dtype="float32"), 1, 4096),
        "config 4 plain batch 64 fp32": (cfg4, dataclasses.replace(
            tc4, use_pallas=False, batch_size=64, compute_dtype="float32"), 1, 4096),
        "config 4 plain batch 2048 bf16": (cfg4, dataclasses.replace(
            tc4, use_pallas=False, batch_size=2048, compute_dtype="bfloat16"), 1, 16384),
    }
    rates = {}
    for name, (cfg, tc, epochs, rows) in runs.items():
        part = [d[:rows] for d in data]
        train_loop_fused(cfg, tc, part, epochs=1, device="cuda")
        _, h = train_loop_fused(cfg, tc, part, epochs=epochs, device="cuda")
        rates[f"train_loop_fused {name} samples/s"] = h[0]["samples_per_sec"]
    for path, (same, _, _) in conv_plain_bits().items():
        rates[f"config 4 {path} same bits"] = float(same)
    return rates


def _round() -> dict:
    """One round in this process: {case: ms}, {case + " busy": ms}, and the
    training rates."""
    import numpy as np
    import torch

    from vae_assoc_tpu_torch.configs import default_image_arch, default_traj_arch
    from vae_assoc_tpu_torch.kernels import _build
    from vae_assoc_tpu_torch.kernels import conv_mega as kcm
    from vae_assoc_tpu_torch.kernels import megakernel as km
    from vae_assoc_tpu_torch.kernels import mlp as kmlp
    from vae_assoc_tpu_torch.models.conv import ConvVAE
    from vae_assoc_tpu_torch.models.networks import init_mlp_vae_params

    _build.load()
    rng = np.random.default_rng(0)
    conv = ConvVAE(default_image_arch(), device="cuda", generator=torch.Generator().manual_seed(5))
    enc, dec_c = (lambda f: (f[:10], f[10:]))([t.detach() for t in kcm.flatten(conv)])
    mlp = init_mlp_vae_params(torch.Generator().manual_seed(2), default_image_arch(), device="cuda")
    traj = init_mlp_vae_params(torch.Generator().manual_seed(2), default_traj_arch(), device="cuda")
    flat = [t.detach() for t in km.flatten(mlp)]
    dec = flat[8:]
    enc_l, dec_l = kmlp._pairs(flat[:8]), kmlp._pairs(dec)
    nodx = "want_dx" in inspect.signature(kmlp.encode_bwd).parameters
    wgrads = kmlp.weight_grads
    times = {}

    def t(*shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).cuda()

    with torch.no_grad():
        for b in BATCHES:
            x3, x, z, g, eps = t(b, 28, 28), t(b, 784), t(b, 20), t(b) / b, t(b, 20)
            dmu, dlv, dout = t(b, 20) / b, t(b, 20) / b, t(b, 784) / b
            for cd in DTYPES:
                bwds = {  # the backward kernels whose weight-gradient launches are left out below
                    "mega_dec_loss_bwd": lambda: km.dec_loss_bwd(x, z, dec, g, kind="bernoulli",
                                                                 compute_dtype=cd),
                    "enc_bwd": lambda **kw: kmlp.encode_bwd(enc_l[:2], enc_l[2:], x, dmu, dlv,
                                                            compute_dtype=cd, **kw),
                    "dec_bwd": lambda **kw: kmlp.decode_bwd(dec_l[:2], dec_l[2], z, dout,
                                                            compute_dtype=cd, **kw),
                }
                cases = {
                    f"conv_enc B={b} {cd}": lambda: kcm.conv_enc(enc, x3, compute_dtype=cd),
                    f"conv_dec B={b} {cd}": lambda: kcm.conv_dec(dec_c, z, x3, kind="bernoulli",
                                                                 compute_dtype=cd),
                    f"mega_fwd B={b} {cd}": lambda: km.tower_fwd(flat, x, kind="bernoulli",
                                                                 eps=eps, compute_dtype=cd),
                }
                cases.update({f"{name}+wgrad B={b} {cd}": fn for name, fn in bwds.items()})
                if nodx:
                    for name in ("enc_bwd", "dec_bwd"):
                        cases[f"{name}+wgrad nodx B={b} {cd}"] = (
                            lambda fn=bwds[name]: fn(want_dx=False))
                for case, fn in cases.items():
                    times[case], times[case + " busy"] = _events_ms(fn), _busy_ms(fn)
                kmlp.weight_grads = lambda a, d, compute_dtype="float32": ()
                try:
                    for name, fn in bwds.items():
                        case = f"{name} B={b} {cd}"
                        times[case], times[case + " busy"] = _events_ms(fn), _busy_ms(fn)
                finally:
                    kmlp.weight_grads = wgrads
        for b in STACK_BATCHES:
            x, z = t(b, 784), t(b, 20)
            for cd in DTYPES:
                cases = {
                    f"enc_fwd image B={b} {cd}": lambda: kmlp.encode_mlp_fused(
                        mlp, x, compute_dtype=cd),
                    f"dec_fwd trajectory B={b} {cd}": lambda: kmlp.decode_mlp_fused(
                        traj, z, compute_dtype=cd),
                    f"dec_fwd image B={b} {cd}": lambda: kmlp.decode_mlp_fused(
                        mlp, z, compute_dtype=cd),
                }
                for case, fn in cases.items():
                    times[case], times[case + " busy"] = _events_ms(fn), _busy_ms(fn)
                    times[case + " host"] = _host_ms(fn)
    times.update(_train_rates())
    return times


def _build_all(roots) -> None:
    """Build every root's kernels at once, each in a process of its own."""
    code = "from vae_assoc_tpu_torch.kernels import _build; _build.build()"
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root,
                              env=dict(os.environ, PYTHONPATH=root)) for root in roots]
    for root, p in zip(roots, procs):
        if p.wait(timeout=1500) != 0:
            raise RuntimeError(f"the kernels of {root} did not build")


def main(argv) -> int:
    if argv[:1] == ["--round"]:
        print(json.dumps(_round()), flush=True)
        return 0
    import torch

    if not argv or not torch.cuda.is_available():
        print("time_checkouts: needs a CUDA card and at least one ROOT", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in argv]
    card = _card()
    _build_all(roots)
    runs = {r: [] for r in roots}
    for root in roots + roots[::-1]:
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--round"], cwd=root,
                             env=env, capture_output=True, text=True, check=True, timeout=1500)
        times = json.loads(out.stdout.strip().splitlines()[-1])
        runs[root].append(times)
        for case, v in times.items():
            unit = "" if case.endswith(("samples/s", "same bits")) else " ms"
            print(f"{root} round {len(runs[root])}: {case} "
                  f"{'not measured' if v is None else f'{v:.4f}{unit}'} [{card}]", flush=True)
    means = {r: {c: (None if any(t.get(c) is None for t in ts) else sum(t[c] for t in ts) / len(ts))
                 for c in ts[0]} for r, ts in runs.items()}
    print(json.dumps({"card": card, "ms": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
