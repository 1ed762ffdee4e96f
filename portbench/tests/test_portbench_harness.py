"""The harness on the CPU: discovery by name, the result line, the refusal without a card."""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

import pytest

from portbench import run
from portbench.reference import model as ref
from portbench.tests import tiny

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 11  # past 32 signed bits, as the driver's are


def _bench():
    return json.loads((tiny.REPO / "BENCHMARK.json").read_text())


def test_benchmark_names_its_files():
    b = _bench()
    pb = tiny.REPO / "portbench"
    for c in b["configs"]:
        assert NAME.match(c["name"]) and (tiny.REPO / c["file"]).is_file()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert (pb / "mixes" / f"{w['traffic']}.json").is_file()
        assert json.loads((pb / "cells" / f"{w['name']}.json").read_text())["limits"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (pb / "metrics" / f"{m['name']}.py").is_file()
    four = [w["name"] for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4), four
    for w in b["workloads"]:
        c = run.load_cell(tiny.REPO, w["name"])
        assert any(m["name"] == "setup_s" for m in c["end_to_end"]) and len(c["end_to_end"]) >= 2
        assert c["per_layer"]


@pytest.mark.parametrize("config,params", [("assoc-mlp", 2_049_064), ("assoc-conv", 3_939_985)])
def test_configs_at_published_widths(config, params):
    c = json.loads((tiny.REPO / "portbench" / "configs" / f"{config}.json").read_text())
    spec = ref.param_spec(c["model"], tuple(c["assumed"].get("conv_channels", (32, 64))))
    assert sum(math.prod(s) for _, s, _, _ in spec) == params == c["parameters"]
    assert c["reduced"] == []


def test_new_cell_config_and_metric_are_new_files(tmp_path):
    root = tiny.copy_bench(tmp_path)
    before = tiny.digests(root)
    (root / "portbench" / "metrics" / "steps.tiny.py").write_text(
        "def read(obs):\n    return obs.get('steps') if 'trace' in obs else None\n")
    metric = {"name": "steps.tiny", "unit": "steps", "better": "higher", "source": "host_clock",
              "layer": "train loop and step", "moves": "small_batch_samples_per_s"}
    cell = tiny.add_tiny_cell(root, "train", like="c3-train-comp-fp32-b64", limits={
        "loss": 1e-4, "grad1": 1e-4, "change3": 1e-3}, extra_per_layer=[metric])
    after = tiny.digests(root)
    assert {k: after[k] for k in before} == before  # nothing that was there changed
    assert set(after) - set(before) == {
        f"portbench/configs/{cell}.json", f"portbench/mixes/{cell}.json",
        f"portbench/cells/{cell}.json", "portbench/metrics/steps.tiny.py"}

    out = run.run_cell(root, cell, SEED, 0.3, False, device="cpu")
    assert list(out) == CONTRACT_KEYS
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"small_batch_samples_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["device"]["count"] == 1
    assert set(out["check"]) == {"loss", "grad1", "change3"}

    traced = run.run_cell(root, cell, SEED + 1, 0.3, True, device="cpu")
    assert list(traced) == CONTRACT_KEYS[:-1] + ["breakdown", "check"]
    assert traced["metrics"]["steps.tiny"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(traced["breakdown"]["idle_gaps"]) <= 10


def test_same_seed_same_check(tmp_path):
    root = tiny.copy_bench(tmp_path)
    cell = tiny.add_tiny_cell(root, "train", like="c3-train-comp-fp32-b64")
    a = run.run_cell(root, cell, SEED, 0.1, False, device="cpu")["check"]
    b = run.run_cell(root, cell, SEED, 0.1, False, device="cpu")["check"]
    assert a == b


def test_tiny_serving_cell_runs(tmp_path):
    root = tiny.copy_bench(tmp_path)
    cell = tiny.add_tiny_cell(root, "serve", like="c3-serve-http-poisson", rate=100)
    out = run.run_cell(root, cell, SEED, 1.0, False, device="cpu")
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] == 100
    assert out["device"]["count"] == 1
    assert set(out["metrics"]) == {"serve_within_100ms", "setup_s"}
    assert 0 < out["metrics"]["serve_within_100ms"]["value"] <= 100
    traced = run.run_cell(root, cell, SEED + 1, 1.0, True, device="cpu")
    assert set(traced["metrics"]) >= {"latency_p50_ms.serve", "serve_p95_ms",
                                      "rows_per_dispatch.serve", "dispatch_ms.serve"}
    p50, p95 = (traced["metrics"][k]["value"] for k in ("latency_p50_ms.serve", "serve_p95_ms"))
    assert 0 < p50 <= p95


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "c3-train-comp-fp32-b64",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=tiny.REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_serving_readers_count_a_failed_request_as_late():
    lat = [0.004, 0.1, 0.1001, None]
    assert run.read_metric(tiny.REPO, "serve_within_100ms", {"latencies_s": lat}) == 50.0
    assert run.read_metric(tiny.REPO, "latency_p50_ms.serve", {"latencies_s": lat}) == 100.0
    assert run.read_metric(tiny.REPO, "serve_within_100ms", {"latencies_s": []}) is None
