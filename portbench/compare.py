"""The numbers that decide ``correct``: the program's outputs against the reference's.

Training (three steps from the same weights on the same rows and ε):

- ``loss``: the widest relative gap of a step's loss.
- ``grad1``: the first gradient, leaf by leaf: |‖g_prog‖ − ‖g_ref‖| over the
  larger of ‖g_ref‖ and the median leaf's ‖g_ref‖; the worst leaf.
  ``grad1_diff``: ‖g_prog − g_ref‖ over the same, the worst leaf.
- ``change3``: the same of each leaf's change after the three steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf below that moves under Adam by round-off alone).

Serving: ``answer``: the widest gap of a sampled answer, max |y − y_ref|
over the row's max |y_ref|, the worst row.
"""

from __future__ import annotations

import statistics

import torch

STILL = 1e-3  # a leaf whose first gradient is under this share of the median's


def _norms(d: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in d.items()}


def leaf_gap(prog: dict, ref: dict, names=None) -> tuple:
    """(worst gap, its leaf) of the norms of ``prog`` against ``ref``."""
    names = list(ref) if names is None else list(names)
    rn, pn = _norms({n: ref[n] for n in names}), _norms({n: prog[n] for n in names})
    median = statistics.median(rn.values())
    worst = max(names, key=lambda n: abs(pn[n] - rn[n]) / max(rn[n], median, 1e-30))
    return abs(pn[worst] - rn[worst]) / max(rn[worst], median, 1e-30), worst


def moving_leaves(ref_grad1: dict) -> list:
    """The leaves the change is compared over: reference gradient at least
    ``STILL`` of the median leaf's."""
    rn = _norms(ref_grad1)
    median = statistics.median(rn.values())
    return [n for n, v in rn.items() if v >= STILL * median]


def train_readings(prog: tuple, ref: tuple) -> dict:
    """``prog`` and ``ref``: (losses, first gradient, change) each. Every
    number a training cell may compare; its cell file names those it does."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    steps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(pl, rl)]
    moving = moving_leaves(rg)
    rn = _norms(rc)
    pn = _norms(pc)
    median = statistics.median(rn[n] for n in moving)
    change = max(abs(pn[n] - rn[n]) / max(rn[n], median, 1e-30) for n in moving)
    return {"loss": max(steps), "grad1": leaf_gap(pg, rg)[0],
            "grad1_diff": diff_gap(pg, rg), "change3": change}


def resolved_gap(prog: dict, ref: dict, ref_grad1: dict, names, tau: float) -> float:
    """The worst gap of the norms of ``prog`` against ``ref`` over each
    leaf's elements whose ``ref_grad1`` is at least ``tau`` of its RMS."""
    keep = {}
    for n in names:
        g = ref_grad1[n].double()
        keep[n] = g.abs() >= tau * g.square().mean().sqrt()
    return leaf_gap({n: prog[n][keep[n]] for n in names}, {n: ref[n][keep[n]] for n in names},
                    names)[0]


def element_look(prog: tuple, ref: tuple, taus=(2.0**-8, 2.0**-6, 2.0**-4)) -> dict:
    """Where the worst leaf's change gap comes from. For the leaf behind
    ``change3``: the share of its elements whose first gradient has the
    other sign than the reference's, and of ‖c‖² − ‖c_ref‖² that those
    elements carry; the same for the elements under each ``tau`` of the
    leaf's RMS; the sign flips by size of the reference gradient; the
    median |g − g_ref| over the RMS. And the worst leaf's change gap over
    the elements at or above each tau (``resolved_gap``)."""
    (_, pg, pc), (_, rg, rc) = prog, ref
    moving = moving_leaves(rg)
    gap, leaf = leaf_gap(pc, rc, moving)
    g, gr = pg[leaf].double().flatten(), rg[leaf].double().flatten()
    c, cr = pc[leaf].double().flatten(), rc[leaf].double().flatten()
    rms = float(gr.square().mean().sqrt())
    size = gr.abs() / max(rms, 1e-300)
    d = c.square() - cr.square()
    total = float(d.sum())

    def share(mask):
        return [round(float(mask.double().mean()), 5), round(float(d[mask].sum()) / total, 4)
                if total else None]

    flip = torch.sign(g) != torch.sign(gr)
    edges = [0.0, 2.0**-8, 2.0**-6, 2.0**-4, 2.0**-2, float("inf")]
    by_size = []
    for lo, hi in zip(edges, edges[1:]):
        m = (size >= lo) & (size < hi)
        by_size.append([int(m.sum()), round(float(flip[m].double().mean()), 4) if m.any() else None])
    return {"leaf": leaf, "gap": gap, "sign_flips": share(flip),
            "small": {f"{t:.4g}": share(size < t) for t in taus},
            "flips_by_size": by_size,
            "err_median": float((g - gr).abs().median()) / max(rms, 1e-300),
            "resolved": {f"{t:.4g}": resolved_gap(pc, rc, rg, moving, t) for t in taus}}


def diff_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's ‖prog − ref‖ over the larger of its ‖ref‖ and the
    median leaf's: where the norms agree and the directions do not."""
    rn = _norms(ref)
    median = statistics.median(rn.values())
    return max(float(torch.linalg.vector_norm((prog[n] - ref[n]).double())) / max(rn[n], median, 1e-30)
               for n in ref)


def worst_leaves(prog: tuple, ref: tuple) -> dict:
    """The leaf behind ``grad1`` and behind ``change3``, and each step's loss gap."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    moving = moving_leaves(rg)
    return {"grad1": leaf_gap(pg, rg)[1], "change3": leaf_gap(pc, rc, moving)[1],
            "loss_steps": [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(pl, rl)]}


def answer_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of any row of ``out`` against ``ref`` [rows, features]."""
    out, ref = out.double(), ref.double()
    scale = ref.abs().amax(dim=1).clamp_min(1e-12)
    return float(((out - ref).abs().amax(dim=1) / scale).max())


def verdict(readings: dict, limits: dict) -> bool:
    """Every reading present, finite and within its limit."""
    return all(
        name in readings and readings[name] == readings[name] and readings[name] <= lim
        for name, lim in limits.items()
    )
