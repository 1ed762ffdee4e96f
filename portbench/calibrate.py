"""The readings that a cell's output-check limits are set from (run on the card).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--seconds 3] [--out FILE]

For each of ``--seeds`` it takes the program's side of a run's check and
compares it with the reference, as a run does; these are the lower
readings. For each of ``--control-seeds`` it puts the reference in the
program's place, computed in the precision just below the cell's
(``CONTROL``), and, for a training cell, the reference with half of each
batch left out of its means, and for a data-parallel cell rank 0 left to
its own gradient (the all-reduce left out); these give the upper
readings. A data-parallel cell starts its ranks once for all the seeds.
A training state left unchanged reads 1 on ``grad1`` and ``change3`` by
their definition and needs no run. A serving cell runs its traffic for
``--seconds`` at the cell's rate for each seed. Prints one JSON object.

The look behind a training cell's limits: for each seed, the program's
numbers against the fp32 reference too, where the worst leaf's change gap
comes from there (``compare.element_look``), and the cell's reference (its
products in the cell's precision) against the fp32 one: a witness of what
that precision alone gives. ``--train key=value`` sets a field of a
one-card training cell's ``train`` mix on the program's side:
``use_pallas=false`` runs the program's plain path, another witness.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import compare, run  # noqa: E402
from portbench.traffic import serve_http, train, train_dp  # noqa: E402

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}  # the nearest precision below


def context(workload: str, seed: int, seconds: float = 3.0, device: str = "cuda", root=ROOT,
            train_overrides=None):
    c = run.load_cell(root, workload)
    mix = c["mix"]
    if train_overrides:
        mix = {**mix, "train": {**mix["train"], **train_overrides}}
    return run.Context(model=c["config"]["model"],
                       conv_channels=tuple(c["config"].get("assumed", {}).get("conv_channels", (32, 64))),
                       mix=mix, limits=c["limits"], seed=int(seed), seconds=float(seconds),
                       trace=False, device=device, t_start=T_START,
                       chips=int(c["cell"]["chips"]))


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def train_readings(ctx, control: bool) -> dict:
    """The program's readings (``control`` False) or the control's and the
    half-batch fault's."""
    cfg, tc, data, w0, state = train.build(ctx)
    blocks = train.check_blocks(data, tc.batch_size)
    if not control:
        state, prog = train.program_steps(cfg, tc, state, blocks)
    del state, data
    _free()
    want = train.reference_steps(ctx, w0, blocks)
    exact = train.reference_steps(ctx, w0, blocks, precision="fp32")
    if not control:
        # The look: the program and the cell's reference, each against the
        # fp32 reference (the same where the cell is fp32).
        look = {**compare.worst_leaves(prog, want),
                "fp32": {**compare.train_readings(prog, exact),
                         "elements": compare.element_look(prog, exact)},
                "reference_vs_fp32": compare.train_readings(want, exact)}
        return {"program": compare.train_readings(prog, want), "look": look}
    low = train.reference_steps(ctx, w0, blocks, precision=CONTROL[tc.compute_dtype])
    half = train.reference_steps(ctx, w0, blocks, half_batch=True)
    return {"control": compare.train_readings(low, want),
            "half_batch": compare.train_readings(half, want),
            "look": {"control": {**compare.worst_leaves(low, want),
                                 "fp32": compare.train_readings(low, exact)},
                     "half_batch": compare.worst_leaves(half, want)}}


def serve_readings(ctx, control: bool) -> dict:
    """The program's answers over a short window, or the control's answers
    for the same sampled requests."""
    server, port, w0, _ = serve_http.start_server(ctx)
    try:
        result = serve_http.generate(port, ctx.seed, ctx.mix["rate_per_s"], ctx.seconds, ctx.mix)
    finally:
        server.close()
    del server
    _free()
    if not control:
        return {"program": {"answer": serve_http.reference_gap(ctx, w0, result["sample"])}}
    low = serve_http.reference_answers(ctx, w0, result["sample"], CONTROL[ctx.mix["compute_dtype"]])
    want = serve_http.reference_answers(ctx, w0, result["sample"])
    return {"control": {"answer": compare.answer_gap(low, want)}}


def readings(workload: str, seed: int, control: bool, seconds: float = 3.0,
             device: str = "cuda", root=ROOT, train_overrides=None) -> dict:
    ctx = context(workload, seed, seconds, device, root, train_overrides)
    kind = ctx.mix["kind"]
    fn = {"train": train_readings, "serve_http": serve_readings}[kind]
    return fn(ctx, control)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--train", nargs="*", default=[], metavar="KEY=VALUE",
                   help="set a field of the train mix on the program's side (JSON values)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    overrides = {k: json.loads(v) for k, v in (a.split("=", 1) for a in args.train)}
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from vae_assoc_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(run._cache_env(ROOT) / "build")
    out = {"workload": args.workload, "train": overrides,
           "program": {}, "control": {}, "half_batch": {}, "no_allreduce": {}, "look": {}}
    ctx = context(args.workload, (args.seeds + args.control_seeds)[0], args.seconds)
    if ctx.mix["kind"] == "train_dp":
        if overrides:
            print("calibrate: --train sets the program's side of a one-card training cell only",
                  file=sys.stderr)
            return 2
        out.update(train_dp.calibrate(ctx, args.seeds, args.control_seeds,
                                      CONTROL[ctx.mix["train"]["compute_dtype"]]))
    else:
        out["card"] = torch.cuda.get_device_name()
        for seed in args.seeds:
            r = readings(args.workload, seed, False, args.seconds, train_overrides=overrides)
            out["program"][seed] = r["program"]
            out["look"][seed] = r.get("look")
            print(f"program {seed} {r}", file=sys.stderr, flush=True)
        for seed in args.control_seeds:
            r = readings(args.workload, seed, True, args.seconds)
            out["control"][seed] = r["control"]
            if "half_batch" in r:
                out["half_batch"][seed] = r["half_batch"]
                out["look"][f"control {seed}"] = r["look"]
            print(f"control {seed} {r}", file=sys.stderr, flush=True)
    summary = {}
    for key in ("program", "control", "half_batch", "no_allreduce"):
        rows = list(out[key].values())
        if rows:
            agg = max if key == "program" else min
            summary[key] = {k: agg(r[k] for r in rows) for k in rows[0]}
    out["summary"] = summary
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
