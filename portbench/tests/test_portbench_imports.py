"""Nothing the harness or the reference loads is JAX or the JAX package, and
the reference loads nothing of the program. Fresh processes: what the test
process itself imported does not count."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.tests import tiny

PROBE = """
import json, sys
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level_modules(body: str) -> set:
    p = subprocess.run([sys.executable, "-c", PROBE.format(repo=str(tiny.REPO), body=body)],
                       capture_output=True, text=True, timeout=600, cwd=tiny.REPO)
    assert p.returncode == 0, p.stderr[-4000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_program():
    mods = _top_level_modules("import portbench.reference.model")
    assert not mods & {"jax", "jaxlib", "flax", "vae_assoc_tpu", "vae_assoc_tpu_torch"}


def test_a_whole_run_loads_no_jax(tmp_path):
    root = tiny.copy_bench(tmp_path)
    cell = tiny.add_tiny_cell(root, "train", like="c4-train-convk-bf16-b16384", pairs=32, batch=8)
    body = f"""
import pathlib, importlib
from portbench import run, calibrate, compare, inputs, roofline, trace
from portbench.traffic import train, serve_http, loadgen
out = run.run_cell(pathlib.Path({str(root)!r}), {cell!r}, 2**31 + 3, 0.1, True, device="cpu")
assert run.loaded_forbidden() == [], run.loaded_forbidden()
"""
    mods = _top_level_modules(body)
    assert "vae_assoc_tpu_torch" in mods  # the run drove the program ...
    assert not mods & {"jax", "jaxlib", "flax", "vae_assoc_tpu"}  # ... and nothing of JAX
