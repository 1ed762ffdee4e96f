"""The output check against faults planted under the timed path and against the
control, at test size on the CPU; and, on the card, the control at each
cell's own size.

Each test runs the harness as a run does, past its look for a card, on a
tiny copy of a cell (hidden widths cut to 32, small batches) with the
cell's own limits, with one fault planted in the program underneath:

- a step that returns its state unchanged (the optimizer's update skipped),
- half of each batch left out, the means taken over the rest,
- an answer altered where the predictor produces it;

and the control: the plain reference put in the program's place, in the
precision just below the cell's (calibrate.CONTROL).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import calibrate, compare, run
from portbench.tests import tiny
from vae_assoc_tpu_torch import serve
from vae_assoc_tpu_torch.models import assoc
from vae_assoc_tpu_torch.train import step

TRAIN_CELLS = ["c3-train-mega-bf16-b16384", "c4-train-convk-bf16-b16384", "c3-train-comp-fp32-b64"]
SERVE_CELL = "c3-serve-http-poisson"
SEED = 2**31 + 21


def _limits(cell):
    return json.loads((tiny.REPO / "portbench" / "cells" / f"{cell}.json").read_text())["limits"]


@pytest.fixture(params=TRAIN_CELLS)
def train_cell(request, tmp_path):
    root = tiny.copy_bench(tmp_path)
    return root, tiny.add_tiny_cell(root, "train", like=request.param, pairs=64, batch=16)


@pytest.fixture
def serve_cell(tmp_path):
    root = tiny.copy_bench(tmp_path)
    return root, tiny.add_tiny_cell(root, "serve", like=SERVE_CELL, rate=60)


def _run(root, cell, seconds=0.05):
    return run.run_cell(root, cell, SEED, seconds, False, device="cpu")


def _readings(out):
    return {k: v["value"] for k, v in out["check"].items()}


def test_sound_training_reads_far_below_the_faults(train_cell, monkeypatch):
    root, cell = train_cell
    sound = _readings(_run(root, cell))
    monkeypatch.setattr(step.Optimizer, "update", lambda self, grads, state, params, **kw: None)
    broken = _readings(_run(root, cell))
    assert max(broken.values()) == pytest.approx(1.0)  # a gradient or a change of 0
    assert max(sound.values()) < 0.1


def test_state_left_unchanged_is_not_correct(train_cell, monkeypatch):
    root, cell = train_cell
    monkeypatch.setattr(step.Optimizer, "update", lambda self, grads, state, params, **kw: None)
    assert _run(root, cell)["correct"] is False


def test_half_batch_is_not_correct(train_cell, monkeypatch):
    root, cell = train_cell
    whole = assoc.assoc_loss_fn

    def half(params, xs, cfg, **kw):
        return whole(params, [x[: x.shape[0] // 2] for x in xs], cfg, **kw)

    monkeypatch.setattr(assoc, "assoc_loss_fn", half)
    assert _run(root, cell)["correct"] is False


def test_sound_training_run_is_correct(train_cell):
    root, cell = train_cell
    assert _run(root, cell)["correct"] is True


def test_training_control_fails_a_limit(train_cell):
    root, cell = train_cell
    limits = run.load_cell(root, cell)["limits"]  # the cell's own, copied
    r = calibrate.readings(cell, SEED, True, device="cpu", root=root)
    assert not compare.verdict(r["control"], limits)
    assert not compare.verdict(r["half_batch"], limits)


def test_sound_serving_is_correct(serve_cell):
    root, cell = serve_cell
    assert _run(root, cell, 1.0)["correct"] is True


def test_altered_answer_is_not_correct(serve_cell, monkeypatch):
    root, cell = serve_cell
    whole = serve.Predictor._cross

    def altered(self, x, src, dst, cond=None):
        out = whole(self, x, src, dst, cond)
        out[:, 0] += np.float32(1e-3) * np.abs(out).max()
        return out

    monkeypatch.setattr(serve.Predictor, "_cross", altered)
    assert _run(root, cell, 1.0)["correct"] is False


def test_serving_control_fails_the_limit(serve_cell):
    root, cell = serve_cell
    r = calibrate.readings(cell, SEED, True, seconds=1.0, device="cpu", root=root)
    assert not compare.verdict(r["control"], _limits(SERVE_CELL))


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN_CELLS + [SERVE_CELL])
def test_control_fails_at_the_cells_size(card, cell):
    for seed in (SEED, SEED + 1, SEED + 2):
        assert not compare.verdict(calibrate.readings(cell, seed, True)["control"], _limits(cell))
