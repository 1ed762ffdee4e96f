#!/usr/bin/env python3
"""Convert a JAX package model directory to the PyTorch port's checkpoint.

    python scripts/jax_checkpoint_to_torch.py SRC DST [--step N]

SRC is a directory written by ``vae_assoc_tpu``'s ``save_model`` (or the
training driver): ``model_config.json`` and orbax step directories. DST
receives ``model_config.json`` copied as is (its ``data`` section too) and
one whole-state checkpoint of the port (``vae_assoc_tpu_torch.utils.
checkpoint``) at the same step, which ``AssocVariationalAutoEncoder.load``,
``Predictor.load`` and ``python -m vae_assoc_tpu_torch.evaluate`` read.

What the port's train state holds is carried: the step, the weights,
Adam's count and moments, the EMA and its count, and the gradient
accumulator and its ``mini_step``. The JAX PRNG key is not: the port's ε
stream is keyed by the train config's seed (the two packages' streams
differ by design). A field of the optimizer state that the port has no
place for raises with the field's name.

It imports both packages, so it runs where JAX is installed.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import jax
import numpy as np
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vae_assoc_tpu import configs as jcfg  # noqa: E402
from vae_assoc_tpu.train import step as jstep  # noqa: E402
from vae_assoc_tpu.utils import checkpoint as jckpt  # noqa: E402
from vae_assoc_tpu_torch import configs as tcfg  # noqa: E402
from vae_assoc_tpu_torch import convert  # noqa: E402
from vae_assoc_tpu_torch.utils import checkpoint as tckpt  # noqa: E402


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def optimizer_parts(opt_state) -> dict:
    """The optax state's stages the port carries, as numpy: ``adam`` =
    (count, mu, nu), ``ema`` = (count, ema), ``acc`` = (mini_step,
    acc_grads), ``schedule_count`` where a schedule keeps one. Raises on a
    field with no counterpart, naming it."""
    parts: dict = {}

    def walk(node, where):
        if isinstance(node, optax.ScaleByAdamState):
            parts["adam"] = (int(node.count), _numpy(node.mu), _numpy(node.nu))
        elif isinstance(node, jstep.EmaState):
            parts["ema"] = (int(node.count), _numpy(node.ema))
        elif isinstance(node, optax.MultiStepsState):
            if jax.tree.leaves(node.skip_state):
                raise ValueError(f"{where}.skip_state: MultiSteps' skip state has no "
                                 "counterpart in the port")
            parts["acc"] = (int(node.mini_step), _numpy(node.acc_grads))
            parts["gradient_step"] = int(node.gradient_step)
            walk(node.inner_opt_state, f"{where}.inner_opt_state")
        elif isinstance(node, optax.ScaleByScheduleState):
            parts["schedule_count"] = int(node.count)
        elif isinstance(node, optax.EmptyState):
            pass
        elif isinstance(node, tuple) and not hasattr(node, "_fields"):
            for i, child in enumerate(node):
                walk(child, f"{where}[{i}]")
        elif jax.tree.leaves(node):
            fields = getattr(node, "_fields", ())
            raise ValueError(
                f"{where}: optimizer state {type(node).__name__}"
                f"{' (' + ', '.join(fields) + ')' if fields else ''} has no "
                "counterpart in the port"
            )

    walk(opt_state, "opt_state")
    if "adam" not in parts:
        raise ValueError("opt_state: no ScaleByAdamState (the port's optimizer is Adam)")
    count = parts["adam"][0]
    # The port derives the learning rate's and the update counter's values
    # from Adam's count; a state where they disagree cannot be carried.
    for field in ("schedule_count", "gradient_step"):
        if parts.get(field, count) != count:
            raise ValueError(f"opt_state.{field} = {parts[field]} differs from Adam's "
                             f"count {count}; the port keeps one count")
    return parts


def convert_dir(src: str, dst: str, *, step: int | None = None) -> str:
    """Convert SRC into DST (see the module docstring); returns DST."""
    src = os.path.abspath(os.path.expanduser(src))
    dst = os.path.abspath(os.path.expanduser(dst))
    jc, jtc, _ = jcfg.load_model_config(src)
    tc_cfg, ttc, _ = tcfg.load_model_config(src)
    jtc = jtc or jcfg.TrainConfig()
    ttc = ttc or tcfg.TrainConfig()
    state = jckpt.restore(src, jstep.init_train_state(jc, jtc), step=step)
    if np.ndim(state.step) != 0:
        raise ValueError("step: a sweep checkpoint ([E] models) has no counterpart in the "
                         "port, which holds one model")
    parts = optimizer_parts(state.opt_state)
    tstate = convert.train_state_from_jax_numpy(
        _numpy(state.params), parts["adam"], int(state.step), tc_cfg, ttc, "cpu",
        ema=parts.get("ema"), acc=parts.get("acc"),
    )
    os.makedirs(dst, exist_ok=True)
    shutil.copyfile(os.path.join(src, "model_config.json"),
                    os.path.join(dst, "model_config.json"))
    tckpt.save(dst, tstate)
    return dst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="the JAX package's model directory (orbax)")
    p.add_argument("dst", help="the port's model directory to write")
    p.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    args = p.parse_args(argv)
    out = convert_dir(args.src, args.dst, step=args.step)
    print(f"wrote {out} (step {tckpt.latest_step(out)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
