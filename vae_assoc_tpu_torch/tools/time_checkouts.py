"""Time the conv-tower megakernels, the decoder+loss backward kernel and the
stack backward of one or more checkouts of the port on one CUDA card, in
turns.

    python3 vae_assoc_tpu_torch/tools/time_checkouts.py ROOT [ROOT ...]

Each ROOT is a directory holding a ``vae_assoc_tpu_torch`` package (this
repository, or an older commit unpacked with ``git archive``). The rounds
run the roots in order and then in reverse (A, B, B, A), each in a process
of its own that imports that root's package and builds its kernels there. A
round times, at B = 1024 and 16384 in fp32 and bf16, with CUDA events over
10 calls after 2 warm-up calls: ``conv_enc`` and ``conv_dec``
(``kernels/conv_mega.py`` on a config-4 tower, random weights from seed 5,
Bernoulli loss) and ``mega_dec_loss_bwd`` on config 3's image decoder, once
as the wrapper runs it (the kernel and its three ``wgrad`` launches) and
once alone (the wrapper with ``kernels/mlp.weight_grads`` replaced by a
function that launches nothing); ``enc_bwd`` and ``dec_bwd``
(``kernels/mlp.py``'s ``encode_bwd`` and ``decode_bwd`` on config 3's image
encoder and decoder, the same weights) with their ``wgrad`` launches, alone
in the same way, and, where the checkout's wrappers take ``want_dx``, with
their ``wgrad`` launches but without the input gradient (``nodx``); and each
case's device busy time per call, the CUDA kernels' own time that
torch.profiler records over 10 calls (None where it recorded fewer kernels
than calls), which leaves out the device waiting for the host. It prints one
line per (root, round, case) and, as its last line, a JSON object of the
means per root with the card's name and power limit. Exits non-zero without
a CUDA card.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys

BATCHES = (1024, 16384)
DTYPES = ("float32", "bfloat16")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _events_ms(fn, n=10):
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


def _round() -> dict:
    """One round in this process: {case: ms}, and {case + " busy": ms}."""
    import numpy as np
    import torch

    from vae_assoc_tpu_torch.configs import default_image_arch
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
    flat = [t.detach() for t in km.flatten(mlp)]
    dec = flat[8:]
    enc_l, dec_l = kmlp._pairs(flat[:8]), kmlp._pairs(dec)
    nodx = "want_dx" in inspect.signature(kmlp.encode_bwd).parameters
    wgrads = kmlp.weight_grads
    times = {}
    with torch.no_grad():
        for b in BATCHES:
            def t(*shape):
                return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).cuda()

            x3, x, z, g = t(b, 28, 28), t(b, 784), t(b, 20), t(b) / b
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
    return times


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
    runs = {r: [] for r in roots}
    for root in roots + roots[::-1]:
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--round"], cwd=root,
                             env=env, capture_output=True, text=True, check=True, timeout=1500)
        times = json.loads(out.stdout.strip().splitlines()[-1])
        runs[root].append(times)
        for case, ms in times.items():
            print(f"{root} round {len(runs[root])}: {case} "
                  f"{'not measured' if ms is None else f'{ms:.4f} ms'} [{card}]", flush=True)
    means = {r: {c: (None if any(t.get(c) is None for t in ts) else sum(t[c] for t in ts) / len(ts))
                 for c in ts[0]} for r, ts in runs.items()}
    print(json.dumps({"card": card, "ms": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
