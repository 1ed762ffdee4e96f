"""The arithmetic of the metric readers, shared by name.

Each ``portbench/metrics/<metric>.py`` binds ``read`` to one of these; a
reader returns None where the run has nothing for it to read.
"""

from __future__ import annotations


def samples_per_s(obs):
    """Training samples completed in the window over the window's wall
    time; the window ends at the host sync that closes its last call."""
    return obs["samples"] / obs["window_s"] if "samples" in obs else None


def mfu(obs):
    """The training step's model FLOPs (roofline.step_flops, over the plain
    reference) times the steps completed in the measured window, over its
    wall time and the card's peak for the cell's compute dtype, in percent.
    The traced run reads it from its measured window, before the traced one."""
    if "step_flops" not in obs:
        return None
    return 100.0 * obs["step_flops"] * obs["steps"] / obs["window_s"] / obs["peak_flops_per_s"]


def step_roofline(obs):
    """The training step's least time (roofline.least_step_s: its FLOPs over
    the peak, or its compulsory bytes over the memory rate, the larger) over
    the device's busy time a step in the traced window, in percent."""
    tr = obs.get("trace")
    if not tr or not tr["busy_s"] or "least_step_s" not in obs:
        return None
    return 100.0 * obs["least_step_s"] * obs["trace_steps"] / tr["busy_s"]


def idle_share(obs):
    """Share of the traced window, in percent, in which no operation ran on
    the card."""
    tr = obs.get("trace")
    return None if not tr else 100.0 * (1.0 - tr["busy_s"] / obs["trace_window_s"])
