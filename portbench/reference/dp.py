"""The plain reference of one data-parallel training step over W ranks.

A global batch of B rows is split into W shards of B/W rows: rank r takes
rows ``[r·B/W, (r+1)·B/W)`` of the batch as the epoch's permutation orders
it, draws its own ε, and the step descends the mean over the ranks of each
rank's batch-mean loss, which is the global batch's mean loss:

    cost = (1/W) Σ_r loss(rows of r, ε_r)

Two things the program derives from the seed are worked out again here,
from frozen copies of their definitions:

- the order of a one-step epoch that starts at step k:
  ``np.random.default_rng([seed, k]).permutation(B)`` (``train/loop.py::
  epoch_loop``'s shuffle);
- rank r's ε at step k: modality m's Philox stream keyed by
  fold(fold(fold(seed, k), r), m) (``train/step.py::step_seed_of_rank``
  folds the rank into the step's seed; ``models/assoc.py::modality_seeds``
  folds the modality), counter (row within the shard, column).

The loss, its precisions and Adam are ``model.py``'s. This module imports
torch, numpy and ``portbench.reference.model`` only.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref


def rank_seed(seed: int, step: int, rank: int) -> int:
    """The ε seed of ``rank`` at micro-step ``step``."""
    return ref.fold_in(ref.fold_in(seed, step), rank)


def rank_eps(seed: int, step: int, rank: int, rows: int, n_z: int, n_modalities: int,
             device) -> list:
    """ε [rows, n_z] of every modality on ``rank`` at ``step``."""
    s = rank_seed(seed, step, rank)
    return [ref.philox_normal(ref.fold_in(s, k), rows, n_z, device) for k in range(n_modalities)]


def epoch_order(seed: int, step: int, n: int) -> np.ndarray:
    """The order in which a one-step epoch that starts at ``step`` takes n rows."""
    return np.random.default_rng([seed, step]).permutation(n)


def shards(block: list, seed: int, step: int, world: int) -> list:
    """Each rank's rows of the global batch ``block`` (one [B, n_input]
    tensor per modality) at ``step``: ``[[x_r for each modality] for r]``."""
    b = block[0].shape[0]
    if b % world:
        raise ValueError(f"global batch {b} not divisible by {world} ranks")
    order = torch.as_tensor(epoch_order(seed, step, b), device=block[0].device)
    per = b // world
    return [[x[order[r * per:(r + 1) * per]] for x in block] for r in range(world)]


def train_steps(params: dict, model: dict, opt: dict, blocks: list, seed: int, world: int,
                precision="fp32", half_batch=False, ranks=None):
    """Adam (``model.adam_steps``) over one one-step epoch per global batch
    of ``blocks``, step k on ``blocks[k]`` as W ranks take it.

    ``half_batch``: each rank's means over the first half of its rows (how
    a fault that drops half the batch reads). ``ranks``: the ranks whose
    losses the step averages, all by default; ``[0]`` is rank 0 left to its
    own gradient, as a step whose all-reduce is left out steps rank 0.
    Returns (losses, first gradient, change after the last step)."""
    ranks = list(range(world)) if ranks is None else list(ranks)
    n_z = int(model["modalities"][0]["arch"]["n_z"])
    k = len(model["modalities"])
    per_step = [shards(block, seed, step, world) for step, block in enumerate(blocks)]

    def objective(p, step):
        total = None
        for r in ranks:
            xs = per_step[step][r]
            b = xs[0].shape[0]
            eps = rank_eps(seed, step, r, b, n_z, k, xs[0].device)
            rows = slice(0, b // 2) if half_batch else None
            part = ref.loss(p, model, xs, eps, precision, rows=rows)
            total = part if total is None else total + part
        return total / len(ranks)

    return ref.adam_steps(params, opt, objective, len(blocks))
