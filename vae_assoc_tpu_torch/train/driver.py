"""The training CLI (counterpart of vae_assoc_tpu/train/driver.py).

The reference trains from a main script: build the arch dicts, load paired
data, loop over epochs printing the cost, checkpoint now and then, and
after training generate across modalities and plot. Same surface here:

    python -m vae_assoc_tpu_torch.train.driver \\
        --config 3 --epochs 50 --data synthetic --n-samples 4096 \\
        --ckpt-dir run1/ckpt --metrics run1/metrics.jsonl \\
        --plots-dir run1/plots --profile-epochs 2

with the JAX package's flags, one for one, and the same refusals, so one
command line selects the same formulation in both packages. It runs on the
card; ``--cpu`` runs it on the CPU, and without it a host with no GPU
raises.

The layout flags (``--mesh``, ``--zero``, ``--fsdp``, ``--model-parallel``,
``--tp-shard``, ``--data-parallel``, ``--pipeline``) run the layouts of
``vae_assoc_tpu_torch.parallel`` over a ``torch.distributed`` process
group, one process a device: launch with ``torchrun --nproc-per-node N``
(the CLI joins its group, ``env://``), or call ``main`` in processes that
joined one already. ``--mesh N`` must equal the group's size; config 5
spans the whole group where it has more than one process. Rank 0 alone
writes the metrics, checkpoints and plots; every rank gathers the whole
state for them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, NamedTuple

import numpy as np


def _state_bytes(state) -> int:
    """Bytes of a TrainState: every tensor, and its counters as int32 (the
    seed as a 64-bit key)."""
    opt = state.opt_state
    tensors = list(state.params.parameters()) + [t for l in opt.lists() if l is not None
                                                 for t in l]
    return sum(t.numel() * t.element_size() for t in tensors) + 4 * 4 + 8


def _add_spans_to_chrome_trace(path: str, recorded) -> None:
    """Append the program's spans to the Chrome trace at ``path`` as
    complete events on its clock (``ts`` in µs after the trace's
    ``baseTimeNanoseconds``), on the threads the profiler names."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "request": s.request, **(s.attrs or {})}}
        for s in recorded)
    with open(path, "w") as f:
        json.dump(trace, f)


def _dry_compile(cfg, tc) -> int:
    """--dry-compile: the pre-flight sizes of the single-device step from
    shapes alone, on the ``meta`` device (no device memory is touched):
    parameters, train state and batch, the JAX package's three numbers,
    and the matmul and conv FLOPs a step of the plain formulation does
    (``torch.utils.flop_counter``, which cannot see into the kernels).
    torch has no ahead-of-time memory analysis of a step, so the analysis
    is reported unavailable, the JAX package's branch for a backend
    without one."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from vae_assoc_tpu_torch.models import assoc as assoc_mod
    from vae_assoc_tpu_torch.train.step import init_train_state

    meta = torch.device("meta")
    state = init_train_state(cfg, tc, device=meta, params=assoc_mod.AssocVAE(cfg, device=meta))
    spc = tc.steps_per_call
    lead = (spc,) if spc > 1 else ()
    widths = [m.arch["n_input"] for m in cfg.modalities]
    if cfg.n_cond > 0:
        widths.append(cfg.n_cond)
    n_params = sum(p.numel() for p in state.params.parameters())
    batch_bytes = sum(int(np.prod(lead + (tc.batch_size, n))) * 4 for n in widths)
    print(f"params: {n_params:,} ({n_params * 4 / 2**20:.1f} MiB fp32); "
          f"train state {_state_bytes(state) / 2**20:.1f} MiB + "
          f"batch {batch_bytes / 2**20:.1f} MiB", flush=True)

    xs = [torch.empty(tc.batch_size, n, device=meta) for n in widths]
    eps = [torch.empty(tc.batch_size, m.arch["n_z"], device=meta) for m in cfg.modalities]
    params = list(state.params.parameters())
    with FlopCounterMode(display=False) as counter:
        total, _ = assoc_mod.assoc_loss_fn(state.params, xs, cfg, eps=eps,
                                           compute_dtype=tc.compute_dtype,
                                           parity_mode=tc.parity_mode)
        torch.autograd.grad(total, params)
    per_step = counter.get_total_flops()
    if per_step:
        print(f"flops/step: {per_step:.3e} "
              f"({per_step / tc.batch_size:.3e}/sample)", flush=True)
    print("memory analysis unavailable on this backend (torch has no ahead-of-time "
          "memory analysis of a step; torch.cuda.max_memory_allocated after a real "
          "step gives the peak)", flush=True)
    return 0


def build_argparser() -> argparse.ArgumentParser:
    from vae_assoc_tpu_torch.configs import ASSOC_FORMS  # the one source
    p = argparse.ArgumentParser(
        prog="vae_assoc_tpu_torch.train.driver", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--config", type=int, default=3, choices=range(1, 6),
                   help="BASELINE config milestone 1-5")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--data", choices=("synthetic", "uji"), default="synthetic")
    p.add_argument("--n-samples", type=int, default=4096,
                   help="synthetic dataset size")
    p.add_argument("--uji-paths", nargs="*", default=[],
                   help="UJI Pen Characters v2 files (--data uji)")
    p.add_argument("--traj-encoding", choices=("resample", "rbf"),
                   default="resample",
                   help="trajectory parameterization: 'resample' (flattened "
                        "arc-length resample, the reference featurizer) or "
                        "'rbf' (RBF weight vectors; the trajectory arch's "
                        "n_input adapts to 2*centers)")
    p.add_argument("--rbf-centers", type=int, default=100,
                   help="RBF basis size for --traj-encoding rbf")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--steps-per-call", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--lr-schedule", choices=("constant", "cosine"),
                   default=None,
                   help="LR schedule over optimizer updates "
                        "(cosine needs --decay-steps)")
    p.add_argument("--warmup-steps", type=int, default=None,
                   help="linear 0->lr warmup prepended to the schedule")
    p.add_argument("--decay-steps", type=int, default=None,
                   help="cosine decay horizon in optimizer updates")
    p.add_argument("--grad-clip-norm", type=float, default=None,
                   help="clip gradients to this global norm before Adam "
                        "(logged grad_norm stays the raw pre-clip value)")
    p.add_argument("--accum-steps", type=int, default=None,
                   help="micro-batches averaged per optimizer update "
                        "(gradient accumulation)")
    p.add_argument("--ema-decay", type=float, default=None, metavar="D",
                   help="keep an exponential moving average of the weights "
                        "(decay D, e.g. 0.999); validation, keep-best "
                        "selection and post-train eval/plots then use the "
                        "debiased EMA weights. Stored in the optimizer "
                        "state, so it checkpoints and resumes")
    p.add_argument("--augment", action="store_true",
                   help="per-epoch stroke augmentation on the device: random "
                        "per-sample rotation/shear/aspect-jitter/point-"
                        "noise applied to the RAW strokes before "
                        "featurization, so image and trajectory stay a "
                        "consistent pair (ops/augment.py). Host-chunked "
                        "loop only; validation/eval stay on clean data")
    p.add_argument("--augment-rotate", type=float, default=15.0,
                   metavar="DEG", help="max |rotation| in degrees")
    p.add_argument("--augment-shear", type=float, default=0.15)
    p.add_argument("--augment-scale", type=float, default=0.15,
                   help="max aspect-ratio jitter (x scaled by 1±this)")
    p.add_argument("--augment-jitter", type=float, default=0.01,
                   help="per-point Gaussian noise, relative to each "
                        "sample's bounding-box extent")
    p.add_argument("--conditional", action="store_true",
                   help="conditional VAE (Sohn et al. 2015): one-hot class "
                        "labels concatenated into every encoder input and "
                        "decoder latent (n_cond = #classes in the data). "
                        "Requires labeled data; MLP towers only")
    p.add_argument("--kl-beta", type=float, default=None, metavar="B",
                   help="β-VAE weight on the KL terms (default 1.0 = the "
                        "reference objective)")
    p.add_argument("--kl-anneal-steps", type=int, default=None, metavar="N",
                   help="linear 0->kl_beta KL warm-up over N optimizer "
                        "updates")
    p.add_argument("--assoc-warmup-steps", type=int, default=None,
                   metavar="N",
                   help="linear 0->assoc_lambda ramp of the association "
                        "term over N optimizer updates")
    p.add_argument("--assoc-form", default=None,
                   choices=ASSOC_FORMS,
                   help="association-term form: mean_l2 (default, the "
                        "reference), sample_l2, sym_kl, infonce")
    p.add_argument("--assoc-temp", type=float, default=None, metavar="T",
                   help="infonce temperature (default 0.1)")
    p.add_argument("--assoc-negatives", default=None,
                   choices=("local", "global"),
                   help="infonce negative set under sharded layouts: "
                        "'local' (default) contrasts each data shard "
                        "against its own batch; 'global' all-gathers the "
                        "normalized latent means over the data group")
    p.add_argument("--depth", type=int, default=None, metavar="L",
                   help="hidden layers per MLP net (default 2 = the "
                        "reference architecture); conv towers are fixed at 2")
    p.add_argument("--hidden", type=int, default=None, metavar="H",
                   help="hidden-layer width for the MLP towers "
                        "(default 500)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 matmul operands (fp32 accumulation)")
    p.add_argument("--use-pallas", action="store_true",
                   help="route through the hand-written CUDA kernels "
                        "(the JAX package's name for its fused kernels)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each modality tower's forward in the "
                        "backward (activation checkpointing)")
    p.add_argument("--fused", action="store_true",
                   help="train_loop_fused: every epoch enqueued with one "
                        "host sync at the end")
    p.add_argument("--preempt-chunk", type=int, default=0, metavar="N",
                   help="with --ckpt-dir: cap training chunks at N epochs "
                        "so a SIGTERM (preemption) checkpoints within N "
                        "epochs even when no --ckpt-every/--val-every "
                        "boundary exists. Off by default: extra chunking "
                        "re-seeds the per-chunk shuffle stream")
    p.add_argument("--dry-compile", action="store_true",
                   help="pre-flight: the single-device step's parameter, "
                        "state and batch sizes and FLOPs from shapes alone "
                        "(no data, no training, no device memory), then "
                        "exit")
    p.add_argument("--display-step", type=int, default=1)
    p.add_argument("--val-frac", type=float, default=0.0,
                   help="hold out this fraction of the data (seeded "
                        "permutation split, stable across --resume) and "
                        "log val_* metrics")
    p.add_argument("--val-every", type=int, default=1,
                   help="evaluate the held-out set every N epochs")
    p.add_argument("--keep-best", action="store_true",
                   help="with --val-frac and --ckpt-dir: also checkpoint "
                        "to CKPT_DIR/best whenever val_total improves")
    p.add_argument("--early-stop-patience", type=int, default=0, metavar="P",
                   help="with --val-frac: stop when val_total has not "
                        "improved for P consecutive validations (0 = off)")
    p.add_argument("--sweep-seeds", type=int, default=0, metavar="E",
                   help="train E models in ONE vmapped program (seeds "
                        "seed..seed+E-1, train/sweep.py), then keep the "
                        "best by val_total (with --val-frac) or final "
                        "train total; post-train eval/plots/checkpoint "
                        "apply to the winner")
    p.add_argument("--sweep-lrs", type=float, nargs="+", default=None,
                   metavar="LR",
                   help="with --sweep-seeds E: per-model learning rates "
                        "(E values; constant schedule only)")
    p.add_argument("--sweep-lambdas", type=float, nargs="+", default=None,
                   metavar="L",
                   help="with --sweep-seeds E: per-model association "
                        "weights (E values)")
    p.add_argument("--mll-samples", type=int, default=0, metavar="K",
                   help="after training, estimate per-modality marginal "
                        "log-likelihood bounds (K-sample IWAE + ELBO, "
                        "nats/sample) on the eval split (0 = off)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=10,
                   help="checkpoint every N epochs")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint from --ckpt-dir")
    p.add_argument("--metrics", default=None, help="metrics JSONL path")
    p.add_argument("--tensorboard", default=None, metavar="DIR",
                   help="also write TensorBoard scalar event files to DIR")
    p.add_argument("--plots-dir", default=None,
                   help="write post-train eval plots here")
    p.add_argument("--profile-epochs", type=int, default=0,
                   help="wrap the first N epochs in a torch.profiler trace, "
                        "with the program's spans above the host and device "
                        "events")
    p.add_argument("--profile-dir", default="/tmp/vae_assoc_tpu_profile",
                   help="where --profile-epochs writes its Chrome trace")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the card, which "
                        "raises without one)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="persistent build cache: the kernel library and the "
                        "UJI parser build (once) and load under DIR "
                        "(utils/compile_cache.py)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="data parallelism over an N-process group "
                        "(default: the whole group for --config 5 when it "
                        "has more than one process, otherwise one device)")
    p.add_argument("--model-parallel", type=int, default=1, metavar="K",
                   help="tensor-parallel factor: with --mesh N, train over "
                        "a 2-D (N/K, K) (data, model) mesh with Megatron "
                        "splits (parallel/tp.py, the GSPMD names)")
    p.add_argument("--fsdp", action="store_true",
                   help="with --mesh N, shard weights + optimizer state over "
                        "the data axis (ZeRO, parallel/fsdp.py) instead of "
                        "replicating them; combine with --model-parallel K "
                        "for the TP×FSDP layout (parallel/tp_fsdp.py)")
    p.add_argument("--pipeline", type=int, default=0, metavar="S",
                   help="GPipe pipeline parallelism over S stage processes "
                        "(parallel/pp.py): deep uniform-width MLP towers "
                        "(--depth L with (L-1) divisible by S). Alone: "
                        "batches replicated. With --mesh N (N processes, a "
                        "multiple of S): DP×PP, S stages × N/S data "
                        "shards. Mutually exclusive with --model-parallel/"
                        "--fsdp/--zero/--fused")
    p.add_argument("--pp-micro", type=int, default=None, metavar="M",
                   help="with --pipeline S: GPipe microbatch count per data "
                        "shard (default 2·S); the per-shard batch must be "
                        "divisible by M")
    p.add_argument("--zero", action="store_true",
                   help="with --mesh N, ZeRO-shard weights + optimizer state "
                        "over the data axis (parallel/zero.py: all-gather "
                        "weights / reduce-scatter grads); keeps the kernels")
    p.add_argument("--tp-shard", action="store_true",
                   help="with --mesh N, tensor parallelism that KEEPS the "
                        "kernels (parallel/tp.py, the tp_shard names): "
                        "Megatron column x row layer-pair splits, one "
                        "all-reduce per pair; batch replicated. MLP towers "
                        "only")
    p.add_argument("--data-parallel", type=int, default=1, metavar="D",
                   help="with --tp-shard --mesh N: DP x TP on one 2-D "
                        "('data','model') mesh, D data shards x N/D model "
                        "shards, batches sharded over data")
    return p


def load_data(args, device="cuda"):
    """(dataset, [images, trajectory features]) on ``device``."""
    from vae_assoc_tpu_torch.data.pipeline import PairedDataset

    kw = dict(traj_encoding=args.traj_encoding, rbf_centers=args.rbf_centers,
              device=device)
    if args.data == "uji":
        if not args.uji_paths:
            raise SystemExit("--data uji requires --uji-paths")
        ds = PairedDataset.from_uji(args.uji_paths, **kw)
    else:
        ds = PairedDataset.from_synthetic(args.n_samples, seed=args.seed or 0, **kw)
    imgs, trajs = ds.features()
    return ds, [imgs, trajs]


def _run_sweep(args, cfg, tc, data, val_data, log, device="cuda"):
    """--sweep-seeds: E models in one vmapped program; returns the winner.

    Every model's per-epoch metrics are logged as separate JSONL records
    keyed by ``model=i``; the winner is chosen by held-out ``val_total``
    when --val-frac is given (each member evaluated over the WHOLE held-out
    set), else by the final epoch's training total (recon + KL under
    per-model λs)."""
    from vae_assoc_tpu_torch.train import eval as eval_mod
    from vae_assoc_tpu_torch.train.step import eval_params
    from vae_assoc_tpu_torch.train.sweep import select_model, sweep_loop

    e = args.sweep_seeds
    seeds = list(range(tc.seed, tc.seed + e))
    lrs, lams = args.sweep_lrs, args.sweep_lambdas
    print(
        f"sweep: {e} models in one vmapped program; seeds {seeds}"
        + (f", lrs {lrs}" if lrs else "")
        + (f", assoc_lambdas {lams}" if lams else ""),
        flush=True,
    )
    state, history = sweep_loop(
        cfg, tc, data, seeds=seeds, learning_rates=lrs, assoc_lambdas=lams,
        epochs=args.epochs, device=device,
    )
    for ep, h in enumerate(history):
        if ep % args.display_step:
            continue
        for i in range(e):
            log.write(epoch=ep, model=i, **{k: float(v[i]) for k, v in h.items()})
    if val_data is not None:
        scores = []
        for i in range(e):
            vm = eval_mod.eval_metrics(
                eval_params(tc, select_model(state, i)), val_data, cfg,
                batch_size=tc.batch_size, compute_dtype=tc.compute_dtype,
                use_pallas=tc.use_pallas, seed=tc.seed,
            )
            log.write(model=i, **{f"val_{k}": v for k, v in vm.items()})
            scores.append(vm["total"])
        kind = "val_total"
    elif lams:
        # Per-model λ makes `total` incomparable across models (a small λ
        # down-weights its own assoc term), so score by the λ-independent
        # ELBO terms.
        scores = [
            float(sum(history[-1][f"recon_{m.name}"][i] + history[-1][f"kl_{m.name}"][i]
                      for m in cfg.modalities))
            for i in range(e)
        ]
        kind = "final train recon+KL (lambda-independent)"
    else:
        scores = [float(v) for v in history[-1]["total"]]
        kind = "final train total"
    best = int(np.argmin(scores))
    print(
        f"sweep winner: model {best} (seed {seeds[best]}"
        + (f", lr {lrs[best]}" if lrs else "")
        + (f", lambda {lams[best]}" if lams else "")
        + f") by {kind} {scores[best]:.5f}",
        flush=True,
    )
    return select_model(state, best)


def _check_flags(args) -> dict:
    """The JAX CLI's refusals that need no config, and the TrainConfig
    overrides the flags name."""
    overrides = {}
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.steps_per_call is not None:
        overrides["steps_per_call"] = args.steps_per_call
    if args.learning_rate is not None:
        overrides["learning_rate"] = args.learning_rate
    for field in ("lr_schedule", "warmup_steps", "decay_steps",
                  "grad_clip_norm", "accum_steps", "ema_decay",
                  "kl_beta", "kl_anneal_steps", "assoc_warmup_steps"):
        v = getattr(args, field)
        if v is not None:
            overrides[field] = v
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.remat:
        overrides["remat"] = True
    if args.bf16:
        overrides["compute_dtype"] = "bfloat16"
    if args.use_pallas:
        overrides["use_pallas"] = True
    if args.zero and (args.fsdp or args.model_parallel > 1):
        raise SystemExit("--zero owns the whole layout (a 1-D data mesh); it "
                         "cannot combine with --fsdp or --model-parallel")
    if args.tp_shard and (args.fsdp or args.model_parallel > 1 or args.zero):
        raise SystemExit("--tp-shard owns the whole layout (a model mesh, "
                         "optionally x data with --data-parallel); it cannot "
                         "combine with --fsdp/--model-parallel/--zero")
    if args.data_parallel < 1:
        raise SystemExit("--data-parallel needs D >= 1")
    if args.data_parallel > 1 and not args.tp_shard:
        raise SystemExit("--data-parallel D is the DP x TP composition knob; "
                         "it requires --tp-shard (plain data parallelism is "
                         "just --mesh N)")
    if args.fsdp or args.model_parallel > 1:
        # These layouts run the plain model path, whatever the config says
        # (config 5 sets use_pallas=True), as the JAX CLI does.
        if args.use_pallas:
            raise SystemExit("--model-parallel/--fsdp run the plain model "
                             "path (no --use-pallas)")
        overrides["use_pallas"] = False
    if args.pipeline:
        if args.pipeline < 2:
            raise SystemExit("--pipeline needs S >= 2 stages")
        if (args.model_parallel > 1 or args.fsdp or args.zero or args.fused
                or args.tp_shard):
            raise SystemExit(
                "--pipeline owns the whole layout (a stage mesh, optionally "
                "× data with --mesh N); it cannot combine with "
                "--model-parallel/--fsdp/--zero/--tp-shard/--fused"
            )
        if args.mesh:
            # DP×PP: --mesh N is the TOTAL device count, S stages × N/S
            # data shards.
            if args.mesh % args.pipeline or args.mesh <= args.pipeline:
                raise SystemExit(
                    f"--pipeline {args.pipeline} with --mesh {args.mesh}: "
                    "the mesh is S stages × (N/S) data shards, so N must "
                    "be a multiple of S greater than S"
                )
        if args.use_pallas:
            raise SystemExit("--pipeline runs the plain model path "
                             "(no --use-pallas)")
        overrides["use_pallas"] = False
    if args.pp_micro is not None and not args.pipeline:
        raise SystemExit("--pp-micro only applies with --pipeline S")
    if args.preempt_chunk < 0:
        raise SystemExit("--preempt-chunk must be >= 0 (0 = off)")
    if args.preempt_chunk and not args.ckpt_dir:
        raise SystemExit("--preempt-chunk requires --ckpt-dir (it exists "
                         "to bound the SIGTERM-to-checkpoint latency)")
    if args.remat and args.pipeline:
        raise SystemExit(
            "--remat wraps the standard per-tower forward; the pipeline "
            "step has its own stage-split ring forward (parallel/pp.py) "
            "with no tower boundary to checkpoint at"
        )
    return overrides


def _resize(cfg, args):
    """The config with the --assoc-*, --depth/--hidden and --traj-encoding
    flags applied."""
    if args.assoc_form:
        if args.assoc_form != "mean_l2" and len(cfg.modalities) < 2:
            raise SystemExit(
                f"--assoc-form {args.assoc_form} needs a multi-modality "
                "config (the association term couples modality pairs)"
            )
        cfg = dataclasses.replace(cfg, assoc_form=args.assoc_form)
    if args.assoc_negatives:
        if (args.assoc_form or cfg.assoc_form) != "infonce":
            raise SystemExit("--assoc-negatives only applies with "
                             "--assoc-form infonce")
        cfg = dataclasses.replace(cfg, assoc_negatives=args.assoc_negatives)
    if args.assoc_temp is not None:
        if (args.assoc_form or cfg.assoc_form) != "infonce":
            raise SystemExit("--assoc-temp only applies with "
                             "--assoc-form infonce")
        if args.assoc_temp <= 0:
            raise SystemExit(f"--assoc-temp must be > 0, got {args.assoc_temp}")
        cfg = dataclasses.replace(cfg, assoc_temp=args.assoc_temp)
    if args.depth is not None or args.hidden is not None:
        if args.depth is not None and args.depth < 1:
            raise SystemExit("--depth must be >= 1")

        def resize(m):
            if m.encoder != "mlp":
                if args.depth not in (None, 2):
                    raise SystemExit(
                        "--depth: conv towers are fixed at 2 hidden layers "
                        "(configs.ModalityConfig); use the MLP configs"
                    )
                return m  # conv geometry is fixed; --hidden is MLP-only
            depth = args.depth if args.depth is not None else 2
            hidden = args.hidden if args.hidden is not None else 500
            arch = {"n_input": m.arch["n_input"], "n_z": m.arch["n_z"]}
            for i in range(1, depth + 1):
                arch[f"n_hidden_recog_{i}"] = hidden
                arch[f"n_hidden_gener_{i}"] = hidden
            return dataclasses.replace(m, arch=arch)

        cfg = dataclasses.replace(cfg, modalities=tuple(resize(m) for m in cfg.modalities))
    if args.traj_encoding == "rbf":
        # The trajectory modality consumes RBF weight vectors, so its arch
        # n_input follows the encoding width (2 * centers).
        n_in = 2 * args.rbf_centers
        cfg = dataclasses.replace(cfg, modalities=tuple(
            dataclasses.replace(m, arch={**dict(m.arch), "n_input": n_in})
            if m.name == "trajectory" else m
            for m in cfg.modalities
        ))
    return cfg


def _check_sweep(args) -> None:
    if args.sweep_seeds:
        if args.sweep_seeds < 2:
            raise SystemExit("--sweep-seeds needs E >= 2")
        if args.epochs < 1:
            raise SystemExit("--sweep-seeds needs --epochs >= 1")
        for bad, name in (
            (args.fused, "--fused"),
            (args.resume, "--resume"),
            (args.keep_best, "--keep-best"),
            (args.early_stop_patience > 0, "--early-stop-patience"),
            (args.profile_epochs > 0, "--profile-epochs"),
            (bool(args.mesh and args.mesh > 1), "--mesh"),
            (args.model_parallel > 1, "--model-parallel"),
            (args.fsdp, "--fsdp"),
            (args.zero, "--zero"),
            (args.tp_shard, "--tp-shard"),
            (args.pipeline > 0, "--pipeline"),
            (args.remat, "--remat"),
        ):
            if bad:
                raise SystemExit(
                    f"--sweep-seeds is incompatible with {name} (the sweep "
                    "is one single-device vmapped program"
                    + ("; torch.func cannot rematerialize" if name == "--remat" else
                       "; select the winner first, then scale it out") + ")"
                )
        for lst, nm in ((args.sweep_lrs, "--sweep-lrs"),
                        (args.sweep_lambdas, "--sweep-lambdas")):
            if lst is not None and len(lst) != args.sweep_seeds:
                raise SystemExit(
                    f"{nm} needs one value per model "
                    f"({args.sweep_seeds}), got {len(lst)}"
                )
        if args.sweep_lrs is not None and (
                args.lr_schedule not in (None, "constant")
                or (args.warmup_steps or 0) > 0):
            raise SystemExit(
                "--sweep-lrs requires the constant LR schedule with no "
                "warmup (per-model rates scale the Adam direction; a "
                "per-model schedule horizon has no state to live in)"
            )
        if args.sweep_lrs is not None and (args.ema_decay or 0) > 0:
            raise SystemExit(
                "--sweep-lrs is incompatible with --ema-decay (per-model "
                "lr scaling happens outside the optimizer chain, so the "
                "in-chain EMA stage would average the unscaled updates)"
            )
    elif args.sweep_lrs is not None or args.sweep_lambdas is not None:
        raise SystemExit("--sweep-lrs/--sweep-lambdas require --sweep-seeds")


def _device(args, *, join: bool = True):
    """The CLI's device: the card, or the CPU under --cpu. Nothing falls
    back to the CPU: without a GPU and without --cpu this raises.

    In a process group of more than one (torchrun's, or one already
    joined) the group is joined first, unless ``join`` is False: joining
    binds each rank to its own card (``cuda:RANK``), where the data and the
    state are then staged."""
    import torch

    from vae_assoc_tpu_torch.parallel import mesh as mesh_mod

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("the training CLI runs on the card, and torch finds no CUDA "
                           "device; pass --cpu to run on the CPU")
    dt = "cpu" if args.cpu else "cuda"
    if join and _world() > 1:
        mesh_mod.init_distributed(device_type=dt)
        return mesh_mod.local_device(dt)
    return torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())


def _world() -> int:
    """The size of the process group this run belongs to: the initialized
    one, torchrun's (``WORLD_SIZE``), or 1."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


class _Layout(NamedTuple):
    """The parallel layout the flags select: ``loop(state, epochs)``, how a
    whole state enters it (``shard``), and how its state becomes whole
    again on every rank (``gather``)."""

    loop: Callable
    shard: Callable
    gather: Callable


def _layout(args, cfg, tc, device, data):
    """The layout the flags select, or None for one device. A layout runs
    over the whole process group, which ``_device`` has joined."""
    from vae_assoc_tpu_torch import parallel as par
    from vae_assoc_tpu_torch.parallel import mesh as mesh_mod
    from vae_assoc_tpu_torch.parallel import pp as pp_mod
    from vae_assoc_tpu_torch.parallel import tp as tp_mod

    world = _world()
    n_mesh = None if args.pipeline else args.mesh
    if (n_mesh is None and args.config == 5 and world > 1
            and not args.sweep_seeds and not args.pipeline):
        # Config 5 is the data-parallel milestone: the whole group.
        n_mesh = world
    mp = args.model_parallel
    dt = device.type
    if args.pipeline:
        need = args.mesh or args.pipeline
    elif n_mesh is not None and n_mesh > 1:
        need = n_mesh
    elif mp > 1 or args.fsdp or args.zero or args.tp_shard:
        raise SystemExit(
            "--model-parallel/--fsdp/--zero/--tp-shard require --mesh N "
            "with N > 1")
    else:
        return None
    if args.fused and not args.pipeline:
        raise SystemExit("--fused and --mesh are mutually exclusive")
    if need != world:
        raise SystemExit(
            f"--{'pipeline' if args.pipeline and not args.mesh else 'mesh'} {need} needs a "
            f"process group of {need} processes (one device each); this run has {world}. "
            f"Launch it with torchrun --nproc-per-node {need}.")

    if args.pipeline:
        pp_mod.check_pp(cfg, tc, args.pipeline)
        pp_data = args.mesh // args.pipeline if args.mesh else 1
        n_micro = pp_mod._resolve_n_micro(tc, args.pipeline, args.pp_micro, pp_data)
        mesh = pp_mod.make_pp_mesh(args.pipeline, data_parallel=pp_data, device_type=dt)
        print(f"pipeline-parallel over {args.pipeline} stages"
              + (f" × {pp_data} data shards" if pp_data > 1 else "")
              + f", {n_micro} microbatches (GPipe, parallel/pp.py)", flush=True)
        return _Layout(
            lambda state, epochs: pp_mod.pp_train_loop(cfg, tc, data, mesh, epochs=epochs,
                                                       state=state, n_micro=args.pp_micro),
            lambda s: pp_mod.shard_pp_train_state(mesh, s, cfg, tc),
            lambda s: pp_mod.gather_pp_train_state(s, cfg, tc, mesh))
    if mp > 1:
        mesh = mesh_mod.make_mesh(n_mesh, model_axis="model", model_parallel=mp,
                                  device_type=dt)
        if args.fsdp:
            print(f"tensor-parallel x FSDP over a {n_mesh // mp}x{mp} (data, model) mesh",
                  flush=True)
            return _Layout(
                lambda state, epochs: par.tp_fsdp_train_loop(cfg, tc, data, mesh,
                                                             epochs=epochs, state=state),
                lambda s: par.shard_tp_fsdp_train_state(mesh, s, cfg, tc),
                lambda s: par.gather_tp_fsdp_train_state(s, cfg, tc, mesh))
        print(f"data×tensor parallel over a {n_mesh // mp}x{mp} (data, model) mesh",
              flush=True)
        return _Layout(
            lambda state, epochs: par.tp_train_loop(cfg, tc, data, mesh, epochs=epochs,
                                                    state=state),
            lambda s: tp_mod.shard_tp_train_state(mesh, s, cfg, tc),
            lambda s: tp_mod.gather_tp_train_state(s, cfg, tc, mesh))
    if args.tp_shard:
        tp_mod.check_tp_shard(cfg, tc)
        mesh = tp_mod.make_tp_mesh(n_mesh, data_parallel=args.data_parallel, device_type=dt)
        if args.data_parallel > 1:
            print(f"DPxTP (kernels kept): {args.data_parallel} data shards x "
                  f"{n_mesh // args.data_parallel} model shards", flush=True)
        else:
            print(f"tensor-parallel (kernels kept) over {n_mesh} devices", flush=True)
        return _Layout(
            lambda state, epochs: tp_mod.tp_train_loop(cfg, tc, data, mesh,
                                                       epochs=epochs, state=state),
            lambda s: tp_mod.shard_tp_train_state(mesh, s, cfg, tc),
            lambda s: tp_mod.gather_tp_train_state(s, cfg, tc, mesh))
    mesh = mesh_mod.make_mesh(n_mesh, device_type=dt)
    if args.fsdp or args.zero:
        if args.fsdp:
            print(f"fully-sharded data-parallel over {n_mesh} devices", flush=True)
            loop = par.fsdp_train_loop
        else:
            print(f"ZeRO-sharded data-parallel over {n_mesh} devices", flush=True)
            loop = par.zero_train_loop
        return _Layout(
            lambda state, epochs: loop(cfg, tc, data, mesh, epochs=epochs, state=state),
            lambda s: par.shard_zero_train_state(mesh, s, cfg, tc),
            lambda s: par.gather_zero_train_state(s, cfg, tc, mesh))
    print(f"data-parallel over {n_mesh} devices", flush=True)
    return _Layout(
        lambda state, epochs: par.dp_train_loop(cfg, tc, data, mesh, epochs=epochs,
                                                state=state),
        lambda s: mesh_mod.replicate(mesh, s), lambda s: s)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch
    import torch.distributed as dist

    from vae_assoc_tpu_torch.configs import baseline_config, config_to_dict
    from vae_assoc_tpu_torch.ops.sampling import fold_in
    from vae_assoc_tpu_torch.train import eval as eval_mod
    from vae_assoc_tpu_torch.train.loop import train_loop, train_loop_fused
    from vae_assoc_tpu_torch.train.step import eval_params, init_train_state
    from vae_assoc_tpu_torch.utils import checkpoint as ckpt
    from vae_assoc_tpu_torch.utils.logging import MetricsLogger

    if args.compile_cache:
        from vae_assoc_tpu_torch.utils.compile_cache import enable_compile_cache

        enable_compile_cache(args.compile_cache)

    overrides = _check_flags(args)
    cfg, tc = baseline_config(args.config, **overrides)
    cfg = _resize(cfg, args)
    k = len(cfg.modalities)

    if args.dry_compile:
        # A pre-flight: validated before any data work, and for the
        # unconditional case run before the data loads (shapes suffice).
        # --conditional takes n_cond from the data's labels, so that one
        # spelling runs after the conditional block below.
        if args.mesh or args.model_parallel > 1 or args.fsdp or args.zero \
                or args.pipeline or args.sweep_seeds:
            raise SystemExit(
                "--dry-compile analyzes the single-device step (the "
                "fits-one-card question); sharded layouts are not covered"
            )
        if not args.conditional:
            _device(args, join=False)
            return _dry_compile(cfg, tc)

    if args.val_frac > 0 and args.val_every < 1:
        raise SystemExit("--val-every must be >= 1")
    if args.keep_best and args.val_frac <= 0:
        raise SystemExit("--keep-best requires --val-frac")
    if args.keep_best and not args.ckpt_dir:
        raise SystemExit("--keep-best requires --ckpt-dir")
    if args.early_stop_patience > 0 and args.val_frac <= 0:
        raise SystemExit("--early-stop-patience requires --val-frac")
    _check_sweep(args)
    device = _device(args, join=not args.dry_compile)

    ds, loaded = load_data(args, device)
    # Each configured modality's features by name (config 2 is
    # trajectory-only: taking the first array would feed images).
    by_name = {"image": loaded[0], "trajectory": loaded[1]}
    data = [by_name[m.name] for m in cfg.modalities]
    cond_full = None
    if args.conditional:
        # Every modality widened to n_cond = #classes, the one-hot condition
        # the trailing batch entry (models.assoc.split_cond), riding
        # through the split, shuffle, shards and eval like any array.
        if ds.labels is None:
            raise SystemExit("--conditional requires labeled data")
        lab = np.asarray(ds.labels, dtype=np.int64)
        n_classes = int(lab.max()) + 1
        try:
            cfg = dataclasses.replace(cfg, modalities=tuple(
                dataclasses.replace(m, n_cond=n_classes) for m in cfg.modalities))
        except ValueError as e:  # e.g. conv towers reject conditioning
            raise SystemExit(f"--conditional: {e}")
        cond_full = torch.eye(n_classes, device=device)[torch.as_tensor(lab, device=device)]
        data = data + [cond_full]
        print(f"conditional: n_cond={n_classes} classes", flush=True)
    if args.dry_compile:  # --conditional spelling: cfg now carries n_cond
        return _dry_compile(cfg, tc)

    val_data = None
    train_idx = None
    eval_labels = ds.labels
    if args.val_frac > 0:
        from vae_assoc_tpu_torch.data.pipeline import split_train_val

        data, val_data, (train_idx, val_idx) = split_train_val(data, args.val_frac,
                                                               seed=tc.seed)
        if eval_labels is not None:
            eval_labels = np.asarray(eval_labels)[val_idx]
    print(
        f"config {args.config}: {k} modalit{'y' if k == 1 else 'ies'}, "
        f"{len(ds)} samples"
        + (f" ({int(data[0].shape[0])} train / "
           f"{int(val_data[0].shape[0])} val)" if val_data else "")
        + f", batch {tc.batch_size}, {device.type} backend",
        flush=True,
    )

    layout = _layout(args, cfg, tc, device, data)
    main_rank = not dist.is_initialized() or dist.get_rank() == 0

    cfg_snapshot = None
    if args.ckpt_dir:
        # Self-describing checkpoints: serving (Predictor.from_checkpoint)
        # and the evaluate CLI rebuild the model from the directory alone.
        # The "data" section records the featurization the model was
        # trained on: the arch width alone cannot tell rbf(100 centers)
        # from resample(100 timesteps), both 200 wide.
        cfg_snapshot = config_to_dict(cfg, tc)
        cfg_snapshot["data"] = {
            "source": args.data,
            "traj_encoding": args.traj_encoding,
            "rbf_centers": args.rbf_centers,
        }

        def _write_cfg(dir_):
            if main_rank:
                os.makedirs(dir_, exist_ok=True)
                with open(os.path.join(dir_, "model_config.json"), "w") as f:
                    json.dump(cfg_snapshot, f, indent=1)

        _write_cfg(args.ckpt_dir)

    def save(path, full):
        if main_rank:
            ckpt.save(path, full)

    state = None if args.sweep_seeds else init_train_state(cfg, tc, device=device)
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume requires --ckpt-dir")
        state = ckpt.restore(args.ckpt_dir, state)
        print(f"resumed from step {int(state.step)}", flush=True)
    if layout is not None:
        state = layout.shard(state)

    def to_full(s):
        """The whole TrainState validation, checkpoints and eval read."""
        return s if layout is None else layout.gather(s)

    log = MetricsLogger(args.metrics if main_rank else None, echo=main_rank,
                        tensorboard_dir=args.tensorboard if main_rank else None)

    if args.augment and (layout is not None or args.fused or args.sweep_seeds):
        raise SystemExit(
            "--augment uses the per-epoch host-chunked loop; it does not "
            "combine with --fused/--mesh/--model-parallel/--fsdp/--zero/"
            "--pipeline/--sweep-seeds"
        )
    aug_refresh_at = None
    if args.augment:
        from vae_assoc_tpu_torch.ops.augment import AugmentConfig

        aug_cfg = AugmentConfig(
            max_rotate=args.augment_rotate,
            max_shear=args.augment_shear,
            max_scale=args.augment_scale,
            point_jitter=args.augment_jitter,
        )
        # One stream per GLOBAL epoch: the offset comes from state.step in
        # run(), so it holds across the chunked train_loop calls and
        # across --resume. With --val-frac only the training rows are
        # augmented (ds.subset).
        aug_base = fold_in(tc.seed, 0xA46)
        aug_ds = ds if train_idx is None else ds.subset(train_idx)
        aug_cond = None
        if args.conditional:
            aug_cond = (cond_full if train_idx is None
                        else cond_full[torch.as_tensor(train_idx, device=device)])

        def aug_refresh_at(offset):
            def refresh(e):
                gen = torch.Generator(device=aug_ds.device)
                gen.manual_seed(fold_in(aug_base, offset + e) >> 1)
                imgs, trajs = aug_ds.features(augment=aug_cfg, generator=gen)
                by = {"image": imgs, "trajectory": trajs}
                fresh = [by[m.name] for m in cfg.modalities]
                if aug_cond is not None:
                    fresh.append(aug_cond)  # labels don't deform
                return fresh

            return refresh

        print(f"augment: {aug_cfg}", flush=True)

    def run(state, epochs):
        if layout is not None:
            return layout.loop(state, epochs)
        if args.fused:
            return train_loop_fused(cfg, tc, data, epochs=epochs, state=state, device=device)
        refresh = None
        if aug_refresh_at is not None:
            # The global epoch from the optimizer step (chunk and resume
            # aware): steps an epoch as train_loop takes them.
            spe = max((data[0].shape[0] // tc.batch_size // tc.steps_per_call)
                      * tc.steps_per_call, 1)
            refresh = aug_refresh_at(int(state.step) // spe)
        return train_loop(cfg, tc, data, epochs=epochs, state=state, refresh_data=refresh,
                          device=device)

    epochs_done = 0
    if args.sweep_seeds:
        # E models in one vmapped program; the winner goes on as a plain
        # single-model state to the checkpoint, eval and plots below.
        state = _run_sweep(args, cfg, tc, data, val_data, log, device)
        epochs_done = args.epochs  # no single-model training loop
    if args.profile_epochs > 0:
        # The first N epochs in a torch.profiler trace (Chrome trace JSON,
        # one file a rank; view with Perfetto or chrome://tracing), with the
        # program's spans, which a running profiler records, above them.
        from torch.profiler import ProfilerActivity, profile

        from vae_assoc_tpu_torch.utils import spans

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        spans.drain()
        with profile(activities=acts) as prof:
            state, history = run(state, args.profile_epochs)
        os.makedirs(args.profile_dir, exist_ok=True)
        rank = dist.get_rank() if dist.is_initialized() else 0
        trace = os.path.join(args.profile_dir, f"trace_rank{rank}.json")
        prof.export_chrome_trace(trace)
        _add_spans_to_chrome_trace(trace, spans.drain())
        for h in history:
            log.write(epoch=epochs_done, **h)
            epochs_done += 1
        print(f"profile written to {trace}", flush=True)

    # Train in chunks bounded by the next event boundary (periodic
    # checkpoint and/or held-out validation), so both see live state.
    ckpt_int = args.ckpt_every if (args.ckpt_dir and args.ckpt_every) else 0
    val_int = args.val_every if val_data is not None else 0
    best_val = float("inf")
    stale = 0  # consecutive validations without a val_total improvement
    if (args.keep_best and args.resume
            and os.path.isdir(os.path.join(args.ckpt_dir, "best"))):
        # The best so far from the existing best/ checkpoint: starting from
        # inf would let the first validation after the restart overwrite a
        # better checkpoint with a worse one. The held-out split is the
        # same across restarts (seeded permutation).
        best_state = ckpt.restore(os.path.join(args.ckpt_dir, "best"),
                                  init_train_state(cfg, tc, device=device))
        best_val = eval_mod.eval_metrics(
            eval_params(tc, best_state), val_data, cfg, batch_size=tc.batch_size,
            compute_dtype=tc.compute_dtype, use_pallas=tc.use_pallas, seed=tc.seed,
        )["total"]
        del best_state
        print(f"resume: existing best checkpoint has val_total={best_val:.5f}", flush=True)

    def _until(done: int, interval: int) -> int:
        """Epochs until the next interval boundary strictly after `done`."""
        return interval - done % interval if interval else args.epochs

    # Preemption: with a checkpoint directory, SIGTERM (what preempted
    # machines and cluster schedulers send) asks for a save and an exit at
    # the next chunk boundary. The handler only sets a flag: a save in
    # the middle of a chunk would tear the (state, data offset) pair that
    # exact resume needs. The latency is one chunk; --preempt-chunk N
    # bounds it. Extra chunking is not applied silently: each chunk seeds
    # its shuffle from (seed, start_step) and stages the data again.
    preempt_chunk = args.preempt_chunk or args.epochs
    stop_signal = None
    if args.ckpt_dir:
        import signal

        def _on_term(signum, frame):
            nonlocal stop_signal
            stop_signal = signum
            print(f"signal {signum} received: checkpointing and exiting at "
                  "the next chunk boundary", flush=True)

        signal.signal(signal.SIGTERM, _on_term)

    def stop_requested() -> bool:
        """Whether any rank got the signal: every rank stops at the same
        boundary, or the others would wait in a collective."""
        stop = stop_signal is not None
        if dist.is_initialized():
            flag = torch.tensor([float(stop)], device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            stop = bool(flag.item())
        return stop

    def run_validation(state, epoch: int):
        nonlocal best_val, stale
        # With --ema-decay the validated (and keep-best-selected) weights
        # are the debiased EMA weights; the checkpoint still saves the
        # whole TrainState, whose optimizer state carries the EMA.
        vm = eval_mod.eval_metrics(
            eval_params(tc, state), val_data, cfg, batch_size=tc.batch_size,
            compute_dtype=tc.compute_dtype, use_pallas=tc.use_pallas, seed=tc.seed,
        )
        log.write(epoch=epoch, **{f"val_{k}": v for k, v in vm.items()})
        if vm["total"] < best_val:
            best_val = vm["total"]
            stale = 0
            if args.keep_best:
                _write_cfg(os.path.join(args.ckpt_dir, "best"))
                save(os.path.join(args.ckpt_dir, "best"), state)
                print(f"new best val_total={vm['total']:.5f} at epoch {epoch}; saved to "
                      f"{os.path.join(args.ckpt_dir, 'best')}", flush=True)
        else:
            stale += 1

    while epochs_done < args.epochs:
        n = min(args.epochs - epochs_done, preempt_chunk,
                _until(epochs_done, ckpt_int), _until(epochs_done, val_int))
        state, history = run(state, n)
        for e, h in enumerate(history):
            if (epochs_done + e) % args.display_step == 0:
                log.write(epoch=epochs_done + e, **h)
        epochs_done += n
        if epochs_done < args.epochs and args.ckpt_dir and stop_requested():
            full = to_full(state)
            save(args.ckpt_dir, full)
            print(f"preempted (signal {stop_signal}): checkpoint saved to "
                  f"{args.ckpt_dir} at epoch {epochs_done - 1} (step "
                  f"{int(full.step)}); continue with --resume", flush=True)
            log.close()
            return 0
        last_chunk = epochs_done >= args.epochs
        if val_int and (epochs_done % val_int == 0 or last_chunk):
            run_validation(to_full(state), epochs_done - 1)
            if (args.early_stop_patience > 0
                    and stale >= args.early_stop_patience
                    and not last_chunk):
                print(f"early stop at epoch {epochs_done - 1}: val_total "
                      f"stale for {stale} validations "
                      f"(best {best_val:.5f})", flush=True)
                break
        if ckpt_int and epochs_done % ckpt_int == 0 and not last_chunk:
            save(args.ckpt_dir, to_full(state))

    state = to_full(state)  # post-train eval, plots and checkpoint
    if args.ckpt_dir:
        save(args.ckpt_dir, state)
        print(f"checkpoint saved to {args.ckpt_dir}", flush=True)

    # Post-train: the cross-modal MSE (the quality gate), recognition, MLL
    # and plots, on the held-out set with --val-frac, else on the head of
    # the data; with --ema-decay on the debiased EMA weights.
    final_params = eval_params(tc, state)
    eval_src = val_data if val_data is not None else data
    n_eval = min(512, int(eval_src[0].shape[0]))
    eval_xs = [d[:n_eval] for d in eval_src]
    mse = eval_mod.evaluate(final_params, eval_xs, cfg, compute_dtype=tc.compute_dtype,
                            use_pallas=tc.use_pallas)
    log.write(**{f"mse_{k}": v for k, v in mse.items()})
    if eval_labels is not None and n_eval >= 2:
        # Latent recognition (the paper's second metric): leave-one-out
        # k-NN accuracy per modality and across modalities.
        rec_xs = eval_xs
        if args.conditional:
            # The label-blind probe: the true one-hot would leak the answer
            # into the latent the k-NN classifies.
            rec_xs = eval_xs[:k] + [eval_mod.label_blind_cond(n_eval, cfg.n_cond)]
        rec = eval_mod.recognition_accuracy(
            final_params, rec_xs, np.asarray(eval_labels)[:n_eval], cfg,
            compute_dtype=tc.compute_dtype, use_pallas=tc.use_pallas,
        )
        log.write(**rec)
        print("recognition:", " ".join(f"{k}={v:.3f}" for k, v in rec.items()), flush=True)
    if args.mll_samples > 0:
        mll = eval_mod.marginal_log_likelihood(
            final_params, eval_xs, cfg, n_importance=args.mll_samples, seed=tc.seed,
            compute_dtype=tc.compute_dtype, use_pallas=tc.use_pallas,
        )
        log.write(**mll)
        print("log-likelihood bounds (nats/sample):",
              " ".join(f"{k}={v:.2f}" for k, v in mll.items()), flush=True)

    if args.plots_dir and k >= 1 and main_rank:
        _plots(args, cfg, tc, ds, final_params, eval_xs, eval_labels, n_eval, device)

    log.close()
    print("done:", " ".join(f"{k}={v:.5f}" for k, v in mse.items()), flush=True)
    return 0


def _plots(args, cfg, tc, ds, params, eval_xs, eval_labels, n_eval, device) -> None:
    """The post-train figures (utils/viz.py, which imports matplotlib)."""
    import torch

    from vae_assoc_tpu_torch.models import assoc as assoc_mod
    from vae_assoc_tpu_torch.train import eval as eval_mod
    from vae_assoc_tpu_torch.utils import viz

    k = len(cfg.modalities)
    os.makedirs(args.plots_dir, exist_ok=True)

    def out(name):
        return os.path.join(args.plots_dir, name)

    # The image plots read modality 0 as the 28x28 image branch; config 2
    # is trajectory-only.
    has_image_0 = cfg.modalities[0].arch["n_input"] == 784
    imgs = eval_xs[0][:8]
    cond8 = eval_xs[k][:8] if args.conditional else None
    gkw = dict(compute_dtype=tc.compute_dtype)
    with torch.no_grad():
        if has_image_0:
            recon = assoc_mod.cross_generate(params, imgs, cfg, src=0, dst=0, cond=cond8, **gkw)
            viz.reconstruction_grid(imgs, recon).savefig(out("reconstructions.png"), dpi=120)
        zs = assoc_mod.transform(params, eval_xs, cfg, **gkw)
        labels = None if eval_labels is None else np.asarray(eval_labels)[:n_eval]
        viz.latent_scatter(zs[0], labels).savefig(out("latent_scatter.png"), dpi=120)
        if has_image_0:
            # The latent manifold over the first two latent dims; a
            # conditional model decodes under the uniform class prior.
            def decode(z, cond=None):
                z = torch.as_tensor(np.asarray(z), dtype=torch.float32, device=device)
                if cond is None and args.conditional:
                    cond = eval_mod.label_blind_cond(z.shape[0], cfg.n_cond)
                if cond is not None:
                    cond = torch.as_tensor(np.asarray(cond), device=device)
                return assoc_mod.generate(params, z, cfg, 0, cond=cond, **gkw)

            viz.latent_manifold(decode, n_z=cfg.n_z).savefig(out("latent_manifold.png"),
                                                              dpi=120)
            if args.conditional:
                # p(x|c) from the prior, no exemplar: the SAME z rows in
                # every class's row, only the condition differs.
                spc = 8
                gen = torch.Generator().manual_seed(tc.seed + 2)
                z_rows = torch.randn(spc, cfg.n_z, generator=gen).numpy()
                viz.class_generation_grid(
                    lambda lab: decode(np.tile(z_rows, (cfg.n_cond, 1)), lab),
                    cfg.n_cond, samples_per_class=spc,
                ).savefig(out("class_generation.png"), dpi=120)
        if k >= 2 and has_image_0:
            gen_traj = assoc_mod.cross_generate(params, imgs, cfg, src=0, dst=1, cond=cond8,
                                                **gkw)
            # Generated features are in the trajectory encoding's space;
            # RBF weight vectors are decoded back to curves first.
            if args.traj_encoding == "rbf":
                gen_traj = ds.decode_trajectories(gen_traj).reshape(gen_traj.shape[0], -1)
            viz.trajectories_over_images(imgs, gen_traj).savefig(
                out("image_to_trajectory.png"), dpi=120)
    print(f"plots written to {args.plots_dir}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
