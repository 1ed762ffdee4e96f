"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration in
``portbench/configs/<config>.json``, its traffic in
``portbench/mixes/<traffic>.json`` (whose ``kind`` names the driver in
``portbench/traffic/<kind>.py``), the limits of its output check in
``portbench/cells/<cell>.json``, and each metric's reader in
``portbench/metrics/<metric>.py``. A new cell, configuration or metric is
a new file and new entries in ``BENCHMARK.json``.

The run sets up (builds or loads the kernel library, makes inputs and
weights from the seed, checks three steps or a sample of answers against
the plain reference, warms up), measures for ``--seconds``, and prints
``{"correct", "attempted", "failed", "metrics", "device", "check"}``: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics and a
``breakdown`` with ``--trace 1``; ``device.count`` is the cell's ``chips``.
Without as many CUDA cards as the cell asks for it prints no result and
exits 2; if JAX or the JAX package was loaded, in this process or in a
rank that the driver started, it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "vae_assoc_tpu")
CACHE_DIR = ".portbench_cache"  # in the checkout; git-ignored


@dataclasses.dataclass
class Context:
    """What a traffic driver gets: the cell's files, the run's arguments."""

    model: dict  # the configuration file's "model" (the JAX package's schema)
    conv_channels: tuple
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    chips: int = 1  # the cell's cards: a driver starts one rank a card


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entry and files, and the metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    pb = root / "portbench"
    return {
        "cell": cell,
        "config": _json(pb / "configs" / f"{cell['config']}.json"),
        "mix": _json(pb / "mixes" / f"{cell['traffic']}.json"),
        "limits": _json(pb / "cells" / f"{workload}.json")["limits"],
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, workload)],
    }


def read_metric(root: Path, name: str, obs: dict):
    """The value of metric ``name`` from the run's observations, or None
    where its reader finds nothing to read."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(obs)


def loaded_forbidden() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Forbidden(RuntimeError):
    """A process that a driver started loaded JAX or the JAX package;
    ``args[0]``: the modules."""


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START) -> dict:
    """Set up, measure and check one run; returns the result object.
    Raises ``Forbidden`` where the driver's ranks loaded JAX
    (``obs["forbidden"]``)."""
    c = load_cell(root, workload)
    ctx = Context(model=c["config"]["model"],
                  conv_channels=tuple(c["config"].get("assumed", {}).get("conv_channels", (32, 64))),
                  mix=c["mix"], limits=c["limits"], seed=int(seed), seconds=float(seconds),
                  trace=bool(trace), device=device, t_start=t_start,
                  chips=int(c["cell"]["chips"]))
    driver = importlib.import_module(f"portbench.traffic.{c['mix']['kind']}")
    obs = driver.run(ctx)
    if obs.get("forbidden"):
        raise Forbidden(list(obs["forbidden"]))
    metrics = {}
    for m in c["per_layer"] if trace else c["end_to_end"]:
        value = read_metric(root, m["name"], obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    from portbench import compare

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": obs.get("device_name", device), "count": ctx.chips,
           "memory_peak_bytes": int(obs.get("memory_peak_bytes", 0))}
    out = {"correct": bool(obs["complete"]) and compare.verdict(obs["readings"], ctx.limits),
           "attempted": int(obs["attempted"]), "failed": int(obs["failed"]),
           "metrics": metrics, "device": dev}
    if trace:
        tr = obs["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], obs.get("trace_window_s", obs["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["check"] = {k: {"value": obs["readings"].get(k), "limit": lim} for k, lim in ctx.limits.items()}
    return out


def _cache_env(root: Path) -> Path:
    """Every build and kernel cache under one fixed directory of the checkout."""
    cache = root / CACHE_DIR
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    return cache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(ROOT, args.workload)["cell"]
    cache = _cache_env(ROOT)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):  # one process, few threads
        os.environ[var] = "1"
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    from vae_assoc_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(cache / "build")
    try:
        out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
        bad = loaded_forbidden()
    except Forbidden as e:
        bad = e.args[0]
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
