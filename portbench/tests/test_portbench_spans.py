"""The span metrics (portbench/spantrace.py) through the harness: a traced run
of the tiny cells reports them, a measured run records no span, a program
without the recorder gives None; and, on the card, a launch made inside a
span lies inside it on the profiler's clock."""

from __future__ import annotations

import sys

import pytest
import torch

from portbench import run, spantrace
from portbench.tests import tiny
from vae_assoc_tpu_torch.utils import spans

SEED = 2**31 + 31
TRAIN = {"host_step_ms.small": "c3-train-comp-fp32-b64",
         "host_step_ms.train": "c3-train-mega-bf16-b16384"}
SERVE = ("http_ms.serve", "queue_wait_ms.serve")


@pytest.fixture
def clean():
    spans.follow_profiler()
    spans.drain()
    yield
    spans.follow_profiler()
    spans.drain()


@pytest.mark.parametrize("metric", sorted(TRAIN))
def test_traced_training_reports_its_step(tmp_path, clean, metric):
    root = tiny.copy_bench(tmp_path)
    cell = tiny.add_tiny_cell(root, "train", like=TRAIN[metric])
    out = run.run_cell(root, cell, SEED, 0.3, False, device="cpu")
    assert spans.drain() == []  # the measured window records no span
    traced = run.run_cell(root, cell, SEED + 1, 0.3, True, device="cpu")
    assert traced["metrics"][metric]["value"] > 0 and traced["metrics"][metric]["unit"] == "ms"
    assert out["correct"] and traced["correct"]


def test_traced_serving_reports_front_end_and_queue(tmp_path, clean):
    root = tiny.copy_bench(tmp_path)
    cell = tiny.add_tiny_cell(root, "serve", like="c3-serve-http-poisson", rate=100)
    traced = run.run_cell(root, cell, SEED, 1.0, True, device="cpu")
    for name in SERVE:
        assert traced["metrics"][name]["value"] > 0, name
    # A request waits out the batcher's coalescing window when alone.
    assert traced["metrics"]["queue_wait_ms.serve"]["value"] >= 0.5 * 2.0


def test_without_the_recorder_the_readers_give_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "vae_assoc_tpu_torch.utils.spans", None)
    obs = {}
    assert spantrace.drained(obs) is None
    assert spantrace.median_span_ms(obs, "train.step") is None and spantrace.http_ms(obs) is None


@pytest.mark.card
def test_launch_in_a_span_lies_in_it_on_the_card(card, clean):
    """The harness's profiler (CUPTI, no host operators) and the program's
    spans on one clock: each kernel launch's runtime call falls inside the
    span that made it, and outside the other spans."""
    a = torch.randn(1024, 1024, device=card)
    (a @ a).sum().item()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for _ in range(5):
        with spans.span("launch"):
            a @ a
        torch.cuda.synchronize()
    prof.stop()
    made = spans.drain()
    origin = prof.profiler.kineto_results.trace_start_ns()
    calls = [origin + e.time_range.start * 1000 for e in prof.events()
             if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")]
    assert len(made) == 5 and len(calls) >= 5
    for s in made:
        assert sum(s.start_ns <= t <= s.end_ns for t in calls) >= 1
    assert all(any(s.start_ns <= t <= s.end_ns for s in made) for t in calls)
