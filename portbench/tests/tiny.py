"""A copy of the benchmark with tiny cells added as new files, for CPU tests."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_WIDTH = 32


def digests(root: Path) -> dict:
    """sha256 of every file of the copy but BENCHMARK.json, by relative path."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def copy_bench(dst: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def add_tiny_cell(root: Path, cell: str, *, like: str, pairs: int = 64, batch: int = 16,
                  limits=None, rate=None, extra_per_layer=(), chips: int = 1,
                  kind=None) -> str:
    """Add ``tiny-<cell>``: the configuration and the traffic of the cell
    ``like`` with every hidden width cut to ``TINY_WIDTH``, ``pairs`` rows
    and ``batch``-row (global) batches (or ``rate`` requests a second),
    ``chips`` ranks, the mix's driver ``kind`` where given (``train_dp``
    for a training cell run data-parallel), and the limits of ``like``
    unless ``limits`` are given. Only new files and new entries of
    BENCHMARK.json. Returns the new cell's name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    src = next(w for w in bench["workloads"] if w["name"] == like)
    pb = root / "portbench"
    config = json.loads((pb / "configs" / f"{src['config']}.json").read_text())
    for m in config["model"]["modalities"]:
        for k in m["arch"]:
            if k.startswith("n_hidden"):
                m["arch"][k] = TINY_WIDTH
    name = f"tiny-{cell}"
    config["name"] = name
    _write(pb / "configs" / f"{name}.json", config)
    mix = json.loads((pb / "mixes" / f"{src['traffic']}.json").read_text())
    if mix["kind"] == "train":
        mix["pairs"], mix["train"]["batch_size"] = pairs, batch
    elif rate is not None:
        mix["rate_per_s"] = rate
    mix["kind"] = kind or mix["kind"]
    _write(pb / "mixes" / f"{name}.json", mix)
    own = json.loads((pb / "cells" / f"{like}.json").read_text())["limits"]
    _write(pb / "cells" / f"{name}.json", {"limits": limits or own})
    bench["configs"].append({"name": name, "source": "a test's cut of " + src["config"],
                             "file": f"portbench/configs/{name}.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": name, "traffic": name, "chips": chips,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    for metric in extra_per_layer:
        bench["per_layer"].append(dict(metric, workloads=[name]))
    _write(root / "BENCHMARK.json", bench)
    return name
