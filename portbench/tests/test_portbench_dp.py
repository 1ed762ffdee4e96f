"""The data-parallel driver on the CPU (``traffic/train_dp.py``): its reference
(``reference/dp.py``), the harness's four-card plumbing, and its output check
against the faults a data-parallel step can have and against the control.

The runs start the driver's ranks as a four-card cell does, with the port's
own launcher, as two gloo processes on a tiny data-parallel copy of the
batch-64 composable fp32 cell (hidden widths cut to 32, 64 pairs, a global
batch of 16) with that cell's own limits.
"""

from __future__ import annotations

import functools
import json

import pytest
import torch

from portbench import calibrate, compare, inputs, run
from portbench.reference import dp as ref_dp
from portbench.reference import model as ref
from portbench.tests import plants, tiny
from portbench.traffic import train_dp

LIKE = "c3-train-comp-fp32-b64"
SEED = 2**31 + 41
WORLD = 2


def _tiny_model():
    c = json.loads((tiny.REPO / "portbench" / "configs" / "assoc-mlp.json").read_text())
    for m in c["model"]["modalities"]:
        for k in m["arch"]:
            if k.startswith("n_hidden"):
                m["arch"][k] = tiny.TINY_WIDTH
    return c["model"]


def _limits():
    return json.loads((tiny.REPO / "portbench" / "cells" / f"{LIKE}.json").read_text())["limits"]


OPT = {"adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-8, "learning_rate": 1e-3}


def _blocks(model, seed, batch=16):
    xs = inputs.make_pairs(model, 3 * batch, seed, "cpu")
    return [[x[k * batch:(k + 1) * batch] for x in xs] for k in range(3)]


def test_reference_at_world_1_is_the_single_card_reference():
    model = _tiny_model()
    w = inputs.make_weights(model, SEED, "cpu")
    blocks = _blocks(model, SEED)
    got = ref_dp.train_steps(w, model, OPT, blocks, SEED, 1, precision="bf16")
    ordered = [[x[torch.as_tensor(ref_dp.epoch_order(SEED, k, 16))] for x in b]
               for k, b in enumerate(blocks)]
    want = ref.train_steps(w, model, OPT, ordered, SEED, precision="bf16",
                           eps_of=lambda step, rows: ref_dp.rank_eps(SEED, step, 0, rows, 20, 2,
                                                                     "cpu"))
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert all(torch.equal(a[n], b[n]) for n in a)


def test_mean_of_the_ranks_is_the_global_batch_mean():
    """Over W ranks the step descends the global batch's mean loss: the
    rows in the epoch's order, each rank's ε in its rows."""
    model = _tiny_model()
    w = inputs.make_weights(model, SEED, "cpu")
    blocks = _blocks(model, SEED)
    got = ref_dp.train_steps(w, model, OPT, blocks, SEED, 4)
    ordered = [[x[torch.as_tensor(ref_dp.epoch_order(SEED, k, 16))] for x in b]
               for k, b in enumerate(blocks)]

    def eps_of(step, rows):
        parts = [ref_dp.rank_eps(SEED, step, r, rows // 4, 20, 2, "cpu") for r in range(4)]
        return [torch.cat(p) for p in zip(*parts)]

    want = ref.train_steps(w, model, OPT, ordered, SEED, eps_of=eps_of)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    assert max(compare.train_readings(got, want).values()) < 1e-5


def _add_dp_cell(root, chips):
    return tiny.add_tiny_cell(root, "dp", like=LIKE, pairs=64, batch=16, chips=chips,
                              kind="train_dp")


@pytest.fixture(scope="module")
def dp_cell(tmp_path_factory):
    root = tiny.copy_bench(tmp_path_factory.mktemp("dp"))
    return root, _add_dp_cell(root, WORLD)


def _run(dp_cell, monkeypatch=None, plant=None, trace=False, seed=SEED):
    root, cell = dp_cell
    if plant is not None:
        monkeypatch.setattr(train_dp, "run", functools.partial(train_dp.run, plant=plant))
    return run.run_cell(root, cell, seed, 0.05, trace, device="cpu")


@pytest.fixture(scope="module")
def sound(dp_cell):
    return _run(dp_cell, trace=True)


def test_sound_run_agrees_with_the_reference(sound):
    assert sound["correct"] is True, sound["check"]
    assert {k: v["limit"] for k, v in sound["check"].items()} == _limits()
    assert sound["attempted"] > 0 and sound["failed"] == 0


def test_result_line_names_the_cells_cards(sound):
    assert sound["device"]["count"] == WORLD
    assert set(sound["metrics"]) >= {"device_idle_share.small", "host_step_ms.small"}
    assert sound["metrics"]["host_step_ms.small"]["value"] > 0
    assert set(sound["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("plant", [plants.state_unchanged, plants.half_batch,
                                   plants.no_allreduce])
def test_fault_is_not_correct(dp_cell, monkeypatch, plant):
    assert _run(dp_cell, monkeypatch, plant)["correct"] is False


def test_jax_in_a_rank_is_refused(dp_cell, monkeypatch):
    with pytest.raises(run.Forbidden, match="jax"):
        _run(dp_cell, monkeypatch, plants.loads_jax)


def test_control_and_faults_fail_a_limit(dp_cell):
    root, cell = dp_cell
    ctx = calibrate.context(cell, SEED, device="cpu", root=root)
    r = train_dp.calibrate(ctx, [], [SEED], calibrate.CONTROL["float32"])
    for key in ("control", "half_batch", "no_allreduce"):
        assert not compare.verdict(r[key][SEED], _limits()), key


# -- the harness's four-card plumbing, with the ranks' observations made up ------------


@pytest.fixture
def four_card_cell(tmp_path):
    root = tiny.copy_bench(tmp_path)
    return root, _add_dp_cell(root, 4)


def _made_up(ctx):
    """Four ranks' observations, as a run on four cards returns them."""
    ranks = [{"memory_peak_bytes": peak, "forbidden": [], "setup_s": 1.0, "window_s": 1.0,
              "samples": 4096, "steps": 1, "attempted": 1, "failed": 0, "complete": True,
              "readings": {"loss": 0.0, "grad1": 0.0, "change3": 0.0}}
             for peak in (5, 9, 7, 8)]
    return train_dp.merge(ranks)


def test_four_card_line_has_the_fullest_cards_peak(four_card_cell, monkeypatch):
    root, cell = four_card_cell
    monkeypatch.setattr(train_dp, "run", _made_up)
    out = run.run_cell(root, cell, SEED, 1.0, False, device="cuda")
    assert out["device"]["count"] == 4 and out["device"]["memory_peak_bytes"] == 9
    assert out["correct"] is True
    assert set(out["metrics"]) == {"small_batch_samples_per_s", "setup_s"}


def test_a_ranks_jax_makes_main_exit_3(four_card_cell, monkeypatch, capsys):
    from vae_assoc_tpu_torch.utils import compile_cache

    root, cell = four_card_cell
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(train_dp, "run", lambda ctx: {"forbidden": ["jax"]})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda d: str(d))
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
                "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.setenv(var, "")
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc == 3 and out == "" and "jax" in err
