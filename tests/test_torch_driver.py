"""The port's training CLI (vae_assoc_tpu_torch/train/driver.py) against the
JAX package's (vae_assoc_tpu/train/driver.py), on the CPU.

- Every flag of the JAX parser exists in the port's with the same type,
  default, choices, nargs and action, and the port adds none.
- Argument lists the JAX CLI refuses raise SystemExit in both ``main``s.
- A tiny run in process (``--cpu --depth 1 --hidden 16``): its JSONL
  records carry the JAX CLI's keys for the same arguments; the
  checkpoint loads in the port's Predictor and evaluate CLI; ``--resume``
  continues from the saved step.
- ``--sweep-seeds 2`` picks its winner by the held-out total.
- ``--dry-compile`` prints JAX's parameter, state and batch sizes.
- SIGTERM makes a CLI subprocess checkpoint and exit 0 at the next chunk,
  and ``--resume`` finishes the run.
- ``--mesh 2 --zero`` and ``--pipeline 2`` on 2 gloo ranks (spawned once
  for the module), and ``--mesh 3`` in a world of 2 refused.
- Without ``--cpu`` the CLI raises on a host with no GPU; under torchrun
  each rank joins the group before it loads data, and stages it on its card.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from vae_assoc_tpu.train import driver as jdrv
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import evaluate as tevaluate
from vae_assoc_tpu_torch import serve as tserve
from vae_assoc_tpu_torch.parallel import mesh
from vae_assoc_tpu_torch.train import driver as tdrv
from vae_assoc_tpu_torch.utils import checkpoint as ckpt
from vae_assoc_tpu_torch.utils.logging import read_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--cpu", "--depth", "1", "--hidden", "16", "--n-samples", "128",
        "--batch-size", "32"]


def _actions(parser):
    return {a.option_strings[-1]: a for a in parser._actions
            if a.option_strings and not isinstance(a, argparse._HelpAction)}


JAX_FLAGS = sorted(_actions(jdrv.build_argparser()))


def test_the_port_adds_no_flag():
    assert sorted(_actions(tdrv.build_argparser())) == JAX_FLAGS
    assert len(JAX_FLAGS) >= 60


@pytest.mark.parametrize("flag", JAX_FLAGS)
def test_flag_matches_jax(flag):
    j = _actions(jdrv.build_argparser())[flag]
    t = _actions(tdrv.build_argparser())[flag]
    assert type(t) is type(j)
    assert (t.option_strings, t.dest, t.type, t.default, t.nargs, t.const) == (
        j.option_strings, j.dest, j.type, j.default, j.nargs, j.const)
    assert (None if t.choices is None else list(t.choices)) == (
        None if j.choices is None else list(j.choices))


# Argument lists the JAX CLI refuses (each also gets "--cpu" and a tiny
# synthetic set, so a list that slipped through would train cheaply).
REFUSED = {
    "zero_fsdp": ["--zero", "--fsdp", "--mesh", "2"],
    "zero_mp": ["--zero", "--model-parallel", "2", "--mesh", "2"],
    "tp_shard_zero": ["--tp-shard", "--zero", "--mesh", "2"],
    "data_parallel_0": ["--data-parallel", "0"],
    "data_parallel_alone": ["--data-parallel", "2", "--mesh", "4"],
    "fsdp_pallas": ["--fsdp", "--use-pallas", "--mesh", "2"],
    "mp_pallas": ["--model-parallel", "2", "--use-pallas", "--mesh", "2"],
    "pipeline_1": ["--pipeline", "1"],
    "pipeline_fused": ["--pipeline", "2", "--fused"],
    "pipeline_zero": ["--pipeline", "2", "--zero"],
    "pipeline_mesh_3": ["--pipeline", "2", "--mesh", "3"],
    "pipeline_mesh_2": ["--pipeline", "2", "--mesh", "2"],
    "pipeline_pallas": ["--pipeline", "2", "--use-pallas"],
    "pp_micro_alone": ["--pp-micro", "2"],
    "preempt_negative": ["--preempt-chunk", "-1"],
    "preempt_no_ckpt": ["--preempt-chunk", "2"],
    "remat_pipeline": ["--remat", "--pipeline", "2"],
    "assoc_form_one_modality": ["--config", "1", "--assoc-form", "infonce"],
    "negatives_not_infonce": ["--assoc-negatives", "global"],
    "temp_not_infonce": ["--assoc-temp", "0.5"],
    "temp_zero": ["--assoc-form", "infonce", "--assoc-temp", "0"],
    "depth_0": ["--depth", "0"],
    "conv_depth": ["--config", "4", "--depth", "3"],
    "dry_compile_mesh": ["--dry-compile", "--mesh", "2"],
    "dry_compile_sweep": ["--dry-compile", "--sweep-seeds", "2"],
    "val_every_0": ["--val-frac", "0.2", "--val-every", "0"],
    "keep_best_no_val": ["--keep-best"],
    "keep_best_no_ckpt": ["--keep-best", "--val-frac", "0.2"],
    "early_stop_no_val": ["--early-stop-patience", "2"],
    "sweep_1": ["--sweep-seeds", "1"],
    "sweep_no_epochs": ["--sweep-seeds", "2", "--epochs", "0"],
    "sweep_fused": ["--sweep-seeds", "2", "--fused"],
    "sweep_resume": ["--sweep-seeds", "2", "--resume"],
    "sweep_profile": ["--sweep-seeds", "2", "--profile-epochs", "1"],
    "sweep_mesh": ["--sweep-seeds", "2", "--mesh", "2"],
    "sweep_fsdp": ["--sweep-seeds", "2", "--fsdp"],
    "sweep_pipeline": ["--sweep-seeds", "2", "--pipeline", "2"],
    "sweep_lrs_count": ["--sweep-seeds", "2", "--sweep-lrs", "0.1"],
    "sweep_lrs_cosine": ["--sweep-seeds", "2", "--sweep-lrs", "0.1", "0.2",
                         "--lr-schedule", "cosine", "--decay-steps", "5"],
    "sweep_lrs_ema": ["--sweep-seeds", "2", "--sweep-lrs", "0.1", "0.2",
                      "--ema-decay", "0.9"],
    "sweep_lambdas_alone": ["--sweep-lambdas", "0.1"],
    "uji_no_paths": ["--data", "uji"],
    "zero_no_mesh": ["--zero"],
    "conditional_conv": ["--config", "4", "--conditional"],
    "resume_no_ckpt": ["--resume"],
    "augment_fused": ["--augment", "--fused"],
}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_match_jax(case, pkg):
    main = jdrv.main if pkg == "jax" else tdrv.main
    with pytest.raises(SystemExit) as e:
        main(["--cpu", "--n-samples", "64", "--batch-size", "16", "--epochs", "1",
              "--depth", "1", "--hidden", "16"] + REFUSED[case])
    assert e.value.code not in (0, None)


def _keys(path):
    """Each record's key set, in order, with the clock left out."""
    return [sorted(k for k in r if k != "t") for r in read_jsonl(path)]


def test_tiny_run_matches_jax_keys_loads_and_resumes(tmp_path, capsys):
    args = TINY + ["--epochs", "2", "--val-frac", "0.25"]
    jm, tm = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    assert jdrv.main(args + ["--metrics", str(jm), "--ckpt-dir", str(tmp_path / "jck")]) == 0
    ck = tmp_path / "ck"
    assert tdrv.main(args + ["--metrics", str(tm), "--ckpt-dir", str(ck)]) == 0
    assert _keys(tm) == _keys(jm)
    recs = read_jsonl(tm)
    totals = [r["total"] for r in recs if "total" in r]
    assert len(totals) == 2 and totals[1] < totals[0]
    assert ckpt.latest_step(ck) == 6  # 96 training rows, batch 32, 2 epochs

    # The directory describes itself: the Predictor and the evaluate CLI
    # rebuild the model from it.
    cfg, tc, raw = tcfg.load_model_config(ck)
    assert raw["data"] == {"source": "synthetic", "traj_encoding": "resample",
                           "rbf_centers": 100}
    pred = tserve.Predictor.from_checkpoint(str(ck), cfg, train_config=tc, device="cpu")
    assert pred.cross_generate(torch.rand(4, 784), "image", "trajectory").shape == (4, 200)
    capsys.readouterr()
    assert tevaluate.main([str(ck), "--device", "cpu", "--n-samples", "64"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["total"])

    assert tdrv.main(args + ["--metrics", str(tm), "--ckpt-dir", str(ck), "--resume",
                             "--epochs", "1"]) == 0
    assert "resumed from step 6" in capsys.readouterr().out
    assert ckpt.latest_step(ck) == 9


def test_sweep_picks_the_winner_by_val_total(tmp_path, capsys):
    m = tmp_path / "m.jsonl"
    assert tdrv.main(TINY + ["--epochs", "2", "--val-frac", "0.25", "--sweep-seeds", "2",
                             "--sweep-lambdas", "0.5", "2", "--metrics", str(m),
                             "--ckpt-dir", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    recs = read_jsonl(m)
    assert sorted({r["model"] for r in recs if "model" in r and "total" in r}) == [0, 1]
    val = {int(r["model"]): r["val_total"] for r in recs if "val_total" in r}
    best = min(val, key=val.get)
    assert f"sweep winner: model {best} (seed {best}, lambda {[0.5, 2.0][best]}) by val_total" \
        in out
    assert ckpt.latest_step(tmp_path / "ck") == 6  # the winner's state


@pytest.mark.parametrize("extra", [[], ["--hidden", "64", "--ema-decay", "0.9",
                                        "--accum-steps", "2", "--bf16"],
                                   ["--config", "2", "--depth", "3", "--hidden", "64",
                                    "--steps-per-call", "4"]])
def test_dry_compile_prints_jax_sizes(extra, capsys):
    def sizes(main):
        assert main(["--cpu", "--dry-compile"] + extra) == 0
        lines = capsys.readouterr().out.splitlines()
        return next(l for l in lines if l.startswith("params:"))

    got, want = sizes(tdrv.main), sizes(jdrv.main)
    assert got == want


def test_sigterm_checkpoints_and_resume_finishes(tmp_path, capsys):
    env = dict(os.environ, PYTHONPATH=REPO)
    ck = tmp_path / "ck"
    base = [sys.executable, "-m", "vae_assoc_tpu_torch.train.driver", "--cpu", "--depth",
            "1", "--hidden", "16", "--n-samples", "64", "--batch-size", "32",
            "--preempt-chunk", "1", "--ckpt-dir", str(ck)]
    proc = subprocess.Popen(base + ["--epochs", "500"], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 120
    try:
        for line in proc.stdout:
            if "total=" in line:
                break
            assert time.monotonic() < deadline
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert "preempted (signal 15): checkpoint saved" in out, out[-2000:]
    step = ckpt.latest_step(ck)
    assert 0 < step < 1000
    assert tdrv.main(base[3:] + ["--epochs", "2", "--resume"]) == 0
    assert f"resumed from step {step}" in capsys.readouterr().out
    assert ckpt.latest_step(ck) == step + 4


def test_augment_conditional_profile_plots_and_mll_run(tmp_path):
    m, plots, prof = tmp_path / "m.jsonl", tmp_path / "plots", tmp_path / "prof"
    assert tdrv.main(TINY + ["--epochs", "2", "--augment", "--conditional", "--metrics", str(m),
                             "--profile-epochs", "1", "--profile-dir", str(prof),
                             "--plots-dir", str(plots), "--mll-samples", "4"]) == 0
    events = json.loads((prof / "trace_rank0.json").read_text())["traceEvents"]
    program = [e for e in events if e.get("cat") == "program_span"]
    assert {"train.call", "train.shuffle", "train.step", "step.forward", "step.backward",
            "step.optimizer", "train.sync"} <= {e["name"] for e in program}
    forward = [(e["ts"], e["ts"] + e["dur"]) for e in program if e["name"] == "step.forward"]
    ops = [e["ts"] for e in events if e.get("cat") == "cpu_op"]
    assert ops and any(a <= t <= b for t in ops for a, b in forward)  # one clock
    assert sorted(os.listdir(plots)) == [
        "class_generation.png", "image_to_trajectory.png", "latent_manifold.png",
        "latent_scatter.png", "reconstructions.png"]
    recs = read_jsonl(m)
    assert len([r for r in recs if "samples_per_sec" in r]) == 2
    mll = next(r for r in recs if "iwae_image" in r)
    assert mll["iwae_image"] >= mll["elbo_image"]


def test_without_cpu_the_cli_raises_on_a_host_with_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--dry-compile"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdrv.main(TINY[1:] + ["--epochs", "1"] + extra)


@pytest.mark.parametrize("rank", [0, 1])
def test_under_torchrun_each_rank_joins_first_and_stages_on_its_card(monkeypatch, rank):
    """torchrun sets RANK and WORLD_SIZE and joins no group: the CLI joins it
    (NCCL, which binds cuda:RANK) before it loads any data, and stages the
    data on that card. A stand-in host with two cards and a recording
    process group; the data load stops the run."""
    import torch.distributed as dist

    seen = {}
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.setdefault("bound", d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.setdefault("backend", backend))
    monkeypatch.setattr(dist, "is_initialized", lambda: "backend" in seen)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)

    class Loaded(Exception):
        pass

    def load_data(args, device):
        seen["data_on"] = device
        raise Loaded

    monkeypatch.setattr(tdrv, "load_data", load_data)
    with pytest.raises(Loaded):
        tdrv.main(TINY[1:] + ["--epochs", "1", "--mesh", "2", "--zero"])
    assert seen == {"bound": rank, "backend": "nccl", "data_on": torch.device("cuda", rank)}


# ---------------------------------------------------------------------------
# Layouts over 2 gloo ranks
# ---------------------------------------------------------------------------


def _layout_worker(rank, root):
    """The CLI under --mesh 2 --zero and --pipeline 2 on this rank, the whole
    state each gathered at the end, and --mesh 3's refusal."""
    from vae_assoc_tpu_torch import parallel as par
    from vae_assoc_tpu_torch.parallel import pp as pp_mod

    gathered = {}

    def keep(name, fn):
        def wrapped(*a, **kw):
            gathered[name] = fn(*a, **kw)
            return gathered[name]
        return wrapped

    par.gather_zero_train_state = keep("zero", par.gather_zero_train_state)
    pp_mod.gather_pp_train_state = keep("pp", pp_mod.gather_pp_train_state)
    out = {}
    base = TINY + ["--epochs", "2"]
    out["zero_rc"] = tdrv.main(base + ["--mesh", "2", "--zero", "--metrics",
                                       os.path.join(root, "zero.jsonl"), "--ckpt-dir",
                                       os.path.join(root, "zero_ck")])
    out["pp_rc"] = tdrv.main(TINY + ["--epochs", "2", "--depth", "3", "--pipeline", "2",
                                     "--metrics", os.path.join(root, "pp.jsonl")])
    out["weights"] = {k: [p.detach().numpy() for p in s.params.parameters()]
                      for k, s in gathered.items()}
    try:
        tdrv.main(base + ["--mesh", "3"])
    except SystemExit as e:
        out["mesh_3"] = str(e)
    return out


@pytest.fixture(scope="module")
def layout_ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("layouts"))
    return root, mesh.spawn(_layout_worker, 2, (root,), device_type="cpu", timeout_s=240)


@pytest.mark.parametrize("layout", ["zero", "pp"])
def test_cli_layouts_on_two_ranks(layout_ranks, layout):
    root, ranks = layout_ranks
    assert [r[f"{layout}_rc"] for r in ranks] == [0, 0]
    for a, b in zip(ranks[0]["weights"][layout], ranks[1]["weights"][layout]):
        np.testing.assert_array_equal(a, b)  # both ranks end with one model
    recs = read_jsonl(os.path.join(root, f"{layout}.jsonl"))
    totals = [r["total"] for r in recs if "total" in r]
    assert len(totals) == 2 and totals[1] < totals[0]  # rank 0 alone wrote them
    if layout == "zero":
        assert ckpt.latest_step(os.path.join(root, "zero_ck")) == 8  # 4 global batches an epoch


def test_cli_mesh_must_equal_the_world(layout_ranks):
    _, ranks = layout_ranks
    for r in ranks:
        assert "--mesh 3 needs a process group of 3" in r["mesh_3"] and "has 2" in r["mesh_3"]
