"""Checkpoints of the whole train state, and the served model's weights.

Counterpart of vae_assoc_tpu/utils/checkpoint.py. ``save`` writes a
:class:`~vae_assoc_tpu_torch.train.step.TrainState` (the step, the
weights, Adam's count and moments, the EMA and its count, the gradient
accumulator and its ``mini_step``, and the ε seed) to one subdirectory per
step, ``<path>/step_<N>/train_state.pt``, and keeps the newest ``keep`` of
them (orbax's ``max_to_keep``). ``restore`` reads one back for exact
resume. The state file is written under a temporary name and renamed
when complete, so a reader never sees half a checkpoint, and a step saved
again keeps its old checkpoint until the new one is whole.

A sharded state (``parallel/zero.py``'s flat slices, ``parallel/tp.py``'s
split leaves) is saved as the whole state its ``gather_*_train_state``
returns on every rank (rank 0 writing it is enough), and restored into a
whole template and cut again by ``shard_*_train_state``: a checkpoint is
one layout, whichever layout wrote it or reads it.

``save_params``/``load_params`` keep the serving layout of a bare model
directory (``model_config.json`` plus ``params.pt``), and ``load_params``
reads the weights of a whole-state checkpoint too. Directories written by
the JAX package hold an orbax checkpoint; ``scripts/jax_checkpoint_to_torch.py``
converts one, and loading one unconverted raises FileNotFoundError.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from vae_assoc_tpu_torch.configs import (
    AssocConfig, TrainConfig, config_to_dict, load_model_config,
)
from vae_assoc_tpu_torch.models.assoc import AssocVAE
from vae_assoc_tpu_torch.models.networks import cuda_or_raise

PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"
DEFAULT_KEEP = 3
_STEP_DIR = re.compile(r"step_(\d+)$")
CONVERTER = "scripts/jax_checkpoint_to_torch.py"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(str(path)))


def all_steps(path: str) -> list:
    """The steps checkpointed under ``path``, ascending."""
    path = _abs(path)
    if not os.path.isdir(path):
        return []
    steps = []
    for name in os.listdir(path):
        m = _STEP_DIR.match(name)
        if m and os.path.exists(os.path.join(path, name, STATE_FILE)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(path: str) -> Optional[int]:
    """The newest step checkpointed under ``path``, or None."""
    steps = all_steps(path)
    return steps[-1] if steps else None


def _host(tensors):
    """Copies on the host: the step updates the weights in place, so the
    payload must not alias them (on a CPU model ``.cpu()`` would)."""
    return None if tensors is None else [t.detach().to("cpu", copy=True) for t in tensors]


def _payload(state) -> dict:
    opt = state.opt_state
    return {
        "step": int(state.step),
        "seed": int(state.seed),
        "params": {k: v.detach().to("cpu", copy=True)
                   for k, v in state.params.state_dict().items()},
        "adam_count": int(opt.adam.count),
        "adam_mu": _host(opt.adam.mu),
        "adam_nu": _host(opt.adam.nu),
        "ema": _host(opt.ema),
        "ema_count": int(opt.ema_count),
        "acc": _host(opt.acc),
        "mini_step": int(opt.mini_step),
    }


def _write(path: str, step: int, payload: dict, keep: int) -> None:
    final = os.path.join(path, f"step_{step}")
    os.makedirs(final, exist_ok=True)
    tmp = os.path.join(final, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(final, STATE_FILE))
    for old in all_steps(path)[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{old}"), ignore_errors=True)


_ASYNC: dict = {}
_ASYNC_LOCK = threading.Lock()


def save(path: str, state, *, step: Optional[int] = None, keep: int = DEFAULT_KEEP,
         block: bool = True) -> str:
    """Save the whole train state under ``path``; returns ``path``.

    The step directory is ``step_<step>`` (``state.step`` by default); the
    newest ``keep`` step directories are kept. ``block=False`` copies
    every tensor device → host before it returns and writes on a thread,
    so training may go on updating the weights in place; ``wait(path)``
    joins the write."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    wait(path)
    path = _abs(path)
    os.makedirs(path, exist_ok=True)
    step = int(state.step) if step is None else int(step)
    payload = _payload(state)
    if block:
        _write(path, step, payload, keep)
    else:
        pool = ThreadPoolExecutor(max_workers=1)
        with _ASYNC_LOCK:
            _ASYNC[path] = pool.submit(_write, path, step, payload, keep)
        pool.shutdown(wait=False)
    return path


def wait(path: str) -> None:
    """Block until any in-flight ``save(block=False)`` to ``path`` is on disk."""
    with _ASYNC_LOCK:
        pending = _ASYNC.pop(_abs(path), None)
    if pending is not None:
        pending.result()  # re-raises what the write raised


def _raise_missing(path: str, what: str):
    orbax = os.path.isdir(path) and any(n.isdigit() for n in os.listdir(path))
    hint = (f" It holds an orbax checkpoint of the JAX package: convert it with "
            f"`python {CONVERTER} {path} <new dir>`.") if orbax else ""
    raise FileNotFoundError(f"no {what} under {path}.{hint}")


def _read(path: str, step: Optional[int], device) -> dict:
    wait(path)
    path = _abs(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            _raise_missing(path, "checkpoints")
    file = os.path.join(path, f"step_{step}", STATE_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(f"no checkpoint of step {step} under {path}; "
                                f"steps there: {all_steps(path)}")
    return torch.load(file, map_location=device, weights_only=True)


def _load_list(dst, src, what: str) -> None:
    if (dst is None) != (src is None):
        raise ValueError(
            f"checkpoint {'has no' if src is None else 'has a'} {what} but the "
            f"train config {'asks for one' if src is None else 'has none'}"
        )
    if dst is None:
        return
    if len(dst) != len(src) or any(a.shape != b.shape for a, b in zip(dst, src)):
        raise ValueError(f"checkpoint's {what} does not match the model's shapes")
    with torch.no_grad():
        torch._foreach_copy_(dst, src)


def restore(path: str, template, *, step: Optional[int] = None):
    """Restore the checkpoint of ``step`` (the latest by default) into
    ``template``'s tensors, in place, and return it with the saved step and
    seed. Shapes and optimizer stages must match the template's."""
    device = next(template.params.parameters()).device
    p = _read(path, step, device)
    template.params.load_state_dict(p["params"], strict=True)
    opt = template.opt_state
    _load_list(opt.adam.mu, p["adam_mu"], "Adam first moment")
    _load_list(opt.adam.nu, p["adam_nu"], "Adam second moment")
    _load_list(opt.ema, p["ema"], "EMA (ema_decay > 0)")
    _load_list(opt.acc, p["acc"], "gradient accumulator (accum_steps > 1)")
    opt.adam.count, opt.ema_count, opt.mini_step = (
        p["adam_count"], p["ema_count"], p["mini_step"])
    return template._replace(step=p["step"], seed=p["seed"])


def save_params(path: str, model: AssocVAE, cfg: AssocConfig,
                tc: TrainConfig | None = None) -> str:
    """Write ``model_config.json`` and ``params.pt`` under ``path``."""
    path = _abs(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(config_to_dict(cfg, tc), f, indent=2)
    torch.save(model.state_dict(), os.path.join(path, PARAMS_FILE))
    return path


def load_params(path: str, *, device="cuda", step: Optional[int] = None):
    """The weights of a model directory → (model, cfg, tc), on ``device``:
    the card unless the caller names the CPU (without a GPU
    ``device="cuda"`` raises). Reads the whole-state checkpoint of ``step``
    (the latest by default) where the directory has one, else the
    ``params.pt`` of :func:`save_params`."""
    device = cuda_or_raise(device, "load_params")
    cfg, tc, _ = load_model_config(path)
    path = _abs(path)
    model = AssocVAE(cfg, device=device)
    if step is not None or all_steps(path):
        state = _read(path, step, device)["params"]
    else:
        params_path = os.path.join(path, PARAMS_FILE)
        if not os.path.exists(params_path):
            _raise_missing(path, f"{PARAMS_FILE} and no checkpoints")
        state = torch.load(params_path, map_location=device, weights_only=True)
    model.load_state_dict(state, strict=True)
    return model, cfg, tc
