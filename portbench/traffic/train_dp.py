"""Data-parallel training traffic: ``dp_train_loop`` on the cell's cards, one epoch a call.

Mix parameters as ``train``'s: ``pairs`` (rows of the dataset, which every
rank holds whole) and ``train`` (the ``TrainConfig`` fields the cell fixes;
``batch_size`` is the global batch, which the ranks split); the run's seed
is the config's ``seed``.

The run starts one rank a card (``ctx.chips``) with the port's own
launcher, ``parallel.mesh.spawn``: on CUDA each rank drives its own card
and the group's backend is NCCL; on the CPU the ranks are gloo processes
(the tests). The parent builds the kernel library first where it is not
built, and touches no card. Each rank makes the same pairs and weights
from the seed on its device, builds the 1-D data mesh (``mesh.make_mesh``)
and the replicated state (``parallel.dp.init_dp_train_state``), and then
drives ``dp_train_loop(cfg, tc, data, mesh, epochs=1, state=state)``, the
training CLI's ``--mesh N`` path:

- the check: three one-step epochs, each over its own block of
  ``batch_size`` global rows; rank 0 keeps each step's loss (the mean over
  the ranks), the first gradient (Adam's first moment over 1 − b1) and
  the change of every weight after the third;
- the warm-up: one whole epoch;
- the window: calls until ``--seconds`` have passed on rank 0's clock;
  after each call rank 0 broadcasts whether to stop, so every rank makes
  the same calls;
- with ``--trace 1``, a traced window of up to ``TRACE_S`` seconds driven
  the same way, every rank under a profiler of its own: ``busy_s`` is the
  mean over the ranks, the breakdown and the program's spans are rank 0's.
  NCCL's kernels count as busy while they wait for a later rank.

Every rank reports its peak memory and what it loaded of
``run.FORBIDDEN``; the run reports the fullest card's peak and every
rank's finds. After the window, with the peak read and the program's
state freed, rank 0 runs the plain reference (``reference/dp.py``) over
the same rows from the same weights, its products in the cell's
precision, and ``compare.train_readings`` sets the program beside it.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time
import types

import torch

from portbench import compare, inputs, roofline, spantrace, trace
from portbench.reference import dp as ref_dp
from portbench.traffic.train import REFERENCE, TRACE_S, check_blocks, program_steps

SPAWN_TIMEOUT_S = 900.0  # the ranks' whole run, and the process group's timeout


def run(ctx, plant=None) -> dict:
    """One run of the cell. ``plant``: a function that every rank calls
    before it builds anything (the tests plant faults with it)."""
    return merge(_spawn(ctx, _rank, plant))


def _spawn(ctx, fn, *args) -> list:
    from vae_assoc_tpu_torch.parallel import mesh

    build_root = None
    if ctx.device == "cuda":
        from vae_assoc_tpu_torch.kernels import _build

        _build.build()  # once, here, rather than in every rank at once
        build_root = str(_build.BUILD_DIR.parent)
    # The ranks time their set-up from the parent's start, on the wall clock.
    spec = dict(vars(ctx), t_start_wall=time.time() - (time.perf_counter() - ctx.t_start))
    return mesh.spawn(fn, ctx.chips, args=(spec, build_root, *args), device_type=ctx.device,
                      timeout_s=SPAWN_TIMEOUT_S)


def merge(ranks: list) -> dict:
    """Rank 0's observations with every rank's folded in: the fullest
    rank's peak memory, every rank's forbidden modules, and in a traced
    run the ranks' mean busy time."""
    obs = dict(ranks[0])
    obs["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in ranks)
    obs["forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
    if "trace" in obs:
        obs["trace"] = dict(obs["trace"], busy_s=statistics.fmean(r["busy_s"] for r in ranks))
    if obs.get("backend"):
        print(f"train_dp: {len(ranks)} ranks, backend {obs['backend']}, "
              f"NCCL {obs.get('nccl_version')}", file=sys.stderr)
    return obs


def build(ctx, mesh, dev):
    """(cfg, tc, data, w0, state) of this rank, from the seed."""
    from vae_assoc_tpu_torch.configs import config_from_dict
    from vae_assoc_tpu_torch.models.assoc import AssocVAE
    from vae_assoc_tpu_torch.parallel import dp

    cfg, tc = config_from_dict({**ctx.model, "train": {**ctx.mix["train"], "seed": ctx.seed}})
    data = inputs.make_pairs(ctx.model, int(ctx.mix["pairs"]), ctx.seed, dev)
    w0 = inputs.make_weights(ctx.model, ctx.seed, dev, ctx.conv_channels)
    model = AssocVAE(cfg, device=dev)
    model.load_state_dict(w0)
    return cfg, tc, data, w0, dp.init_dp_train_state(cfg, tc, mesh, params=model)


def reference_steps(ctx, w0, blocks, precision=None, **kw):
    """The reference's three data-parallel steps on the rows the program
    took (``reference.dp.train_steps``; ``kw``: its faults), its products in
    ``precision`` (by default the cell's, ``REFERENCE``)."""
    precision = precision or REFERENCE[ctx.mix["train"]["compute_dtype"]]
    return ref_dp.train_steps(w0, ctx.model, ctx.mix["train"], blocks, ctx.seed, ctx.chips,
                              precision=precision, **kw)


def check_steps(cfg, tc, mesh, state, blocks):
    """``train.program_steps`` through the window's call, ``dp_train_loop``."""
    from vae_assoc_tpu_torch.parallel import dp

    return program_steps(cfg, tc, state, blocks,
                         call=lambda s, xs: dp.dp_train_loop(cfg, tc, xs, mesh, epochs=1, state=s))


def _join(spec, build_root, plant=None):
    """A rank's start: the planted fault, the kernel library's directory,
    the mesh. Returns (ctx, mesh, device)."""
    if plant is not None:
        plant()
    if build_root is not None:
        from vae_assoc_tpu_torch.utils.compile_cache import enable_compile_cache

        enable_compile_cache(build_root)
    from vae_assoc_tpu_torch.parallel import mesh as mesh_mod

    ctx = types.SimpleNamespace(**spec)
    mesh = mesh_mod.make_mesh(ctx.chips, device_type=ctx.device)
    return ctx, mesh, mesh_mod.mesh_device(mesh)


def _agree(dev, flag: bool = False) -> bool:
    """Rank 0's ``flag`` on every rank, once every rank has come here."""
    import torch.distributed as dist

    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.broadcast(t, src=0)
    return bool(t.item())


def _barrier(dev) -> None:
    import torch.distributed as dist

    t = torch.zeros(1, dtype=torch.int32, device=dev)
    dist.all_reduce(t)
    t.item()


def _window(cfg, tc, data, mesh, state, dev, seconds):
    """Calls of ``dp_train_loop`` until rank 0 has seen ``seconds`` pass.
    Returns (state, calls, seconds on rank 0's clock to the end of the
    last call's host sync)."""
    from vae_assoc_tpu_torch.parallel import dp

    t0 = time.perf_counter()
    calls = 0
    while True:
        state, _ = dp.dp_train_loop(cfg, tc, data, mesh, epochs=1, state=state)
        calls += 1
        elapsed = time.perf_counter() - t0
        if _agree(dev, elapsed >= seconds):
            return state, calls, elapsed


def _rank(rank, spec, build_root, plant):
    import torch.distributed as dist

    from vae_assoc_tpu_torch.parallel import dp
    from vae_assoc_tpu_torch.utils import spans

    ctx, mesh, dev = _join(spec, build_root, plant)
    cuda = dev.type == "cuda"
    cfg, tc, data, w0, state = build(ctx, mesh, dev)
    bs = tc.batch_size
    blocks = check_blocks(data, bs)
    state, prog = check_steps(cfg, tc, mesh, state, blocks)
    state, _ = dp.dp_train_loop(cfg, tc, data, mesh, epochs=1, state=state)
    steps = data[0].shape[0] // bs // tc.steps_per_call * tc.steps_per_call
    _barrier(dev)
    setup_s = time.time() - ctx.t_start_wall
    state, calls, window_s = _window(cfg, tc, data, mesh, state, dev, ctx.seconds)
    obs = {"setup_s": setup_s, "window_s": window_s, "samples": calls * steps * bs,
           "steps": calls * steps, "attempted": calls * steps, "failed": 0, "complete": True}
    prof = trace.profiler(ctx.trace)
    if prof is not None:
        # A traced window of its own after the measured one, as train.py's.
        _barrier(dev)
        prof.start()
        state, traced, obs["trace_window_s"] = _window(cfg, tc, data, mesh, state, dev,
                                                       min(ctx.seconds, TRACE_S))
        prof.stop()
        summary = trace.summarize(prof, obs["trace_window_s"])
        obs["busy_s"] = summary["busy_s"]
        if rank == 0:
            obs["trace"] = summary
            obs["trace_steps"] = traced * steps
            spantrace.drained(obs)
            obs["step_flops"] = roofline.step_flops(ctx.model, bs, ctx.conv_channels)
            obs["peak_flops_per_s"] = ctx.chips * roofline.PEAK_FLOPS_PER_S[tc.compute_dtype]
        else:
            spans.drain()
    obs["backend"] = dist.get_backend()
    if cuda:
        if obs["backend"] != "nccl":
            raise RuntimeError(f"a rank on a card joined a {obs['backend']} group, not NCCL")
        obs["nccl_version"] = ".".join(map(str, torch.cuda.nccl.version()))
        obs["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        obs["device_name"] = torch.cuda.get_device_name(dev)
    else:
        obs["memory_peak_bytes"] = 0
    del state, data, prof
    _free(dev)
    if rank == 0:
        obs["readings"] = compare.train_readings(prog, reference_steps(ctx, w0, blocks))
    from portbench import run as run_mod

    obs["forbidden"] = run_mod.loaded_forbidden()
    return obs


# -- the readings that the cell's limits are set from (portbench/calibrate.py) ---------


def calibrate(ctx, seeds, control_seeds, control_precision) -> dict:
    """The program's readings on each of ``seeds`` and the control's and
    the faults' on each of ``control_seeds``, from one start of the ranks:
    ``{"program", "control", "half_batch", "no_allreduce", "look"}``, each
    by seed, and the ``card`` (what ``calibrate.main`` prints)."""
    return _spawn(ctx, _calibrate_rank, list(seeds), list(control_seeds), control_precision)[0]


def _calibrate_rank(rank, spec, build_root, seeds, control_seeds, control_precision):
    ctx, mesh, dev = _join(spec, build_root)
    out = {"program": {}, "control": {}, "half_batch": {}, "no_allreduce": {}, "look": {}}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    for seed in seeds:
        c = types.SimpleNamespace(**dict(vars(ctx), seed=seed))
        cfg, tc, data, w0, state = build(c, mesh, dev)
        blocks = check_blocks(data, tc.batch_size)
        _, prog = check_steps(cfg, tc, mesh, state, blocks)
        del state, data
        _free(dev)
        if rank == 0:
            want = reference_steps(c, w0, blocks)
            exact = reference_steps(c, w0, blocks, precision="fp32")
            out["program"][seed] = compare.train_readings(prog, want)
            out["look"][seed] = {**compare.worst_leaves(prog, want),
                                 "fp32": compare.train_readings(prog, exact),
                                 "reference_vs_fp32": compare.train_readings(want, exact)}
        _barrier(dev)
    if rank == 0:
        for seed in control_seeds:
            c = types.SimpleNamespace(**dict(vars(ctx), seed=seed))
            data = inputs.make_pairs(c.model, int(c.mix["pairs"]), seed, dev)
            blocks = check_blocks(data, int(c.mix["train"]["batch_size"]))
            del data
            w0 = inputs.make_weights(c.model, seed, dev, c.conv_channels)
            want = reference_steps(c, w0, blocks)
            low = reference_steps(c, w0, blocks, precision=control_precision)
            half = reference_steps(c, w0, blocks, half_batch=True)
            alone = reference_steps(c, w0, blocks, ranks=[0])
            out["control"][seed] = compare.train_readings(low, want)
            out["half_batch"][seed] = compare.train_readings(half, want)
            out["no_allreduce"][seed] = compare.train_readings(alone, want)
            out["look"][f"control {seed}"] = {"control": compare.worst_leaves(low, want),
                                              "half_batch": compare.worst_leaves(half, want),
                                              "no_allreduce": compare.worst_leaves(alone, want)}
            _free(dev)
    return out


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
