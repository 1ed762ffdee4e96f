"""The device trace of a ``--trace 1`` window, reduced to what the per-layer metrics read.

``torch.profiler`` records the card's activity (CUPTI) from the window's
start to its end: every kernel, copy and fill on the device, and the CUDA
runtime calls on the host, from every thread. It records no host operator
of PyTorch: that costs some microseconds an operator and slowed the
megakernel cell's host-bound enqueue by a quarter in a trial, which would
leave the traced window's rates unlike the measured ones. From the trace:

- ``busy_s``: the union of the intervals in which any device operation ran.
- ``launches``: the kernels the card ran, the program's and PyTorch's.
- ``device_ops``: the ten device operations that took the most time.
- ``idle_gaps``: idle device time, summed by the CUDA runtime call the
  host was in at the middle of each gap ("host outside CUDA calls" where
  it was in none: Python, the program's own host work, or waiting for
  work), the ten largest sums. The time before the first and after the
  last device operation of the window counts as "window edges".
"""

from __future__ import annotations

import heapq
from collections import defaultdict

import torch
from torch.autograd import DeviceType


def profiler(enabled: bool):
    """A profiler to ``start()`` at the window's start and ``stop()`` at its
    end, or None."""
    if not enabled:
        return None
    on_card = torch.cuda.is_available()
    act = torch.profiler.ProfilerActivity.CUDA if on_card else torch.profiler.ProfilerActivity.CPU
    return torch.profiler.profile(activities=[act])


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def summarize(prof, window_s: float) -> dict:
    """Reduce a stopped profile of a window that lasted ``window_s``."""
    device, host = [], []
    by_op = defaultdict(float)
    launches = 0
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            device.append((a, b))
            by_op[e.name] += (b - a) * 1e-6
            launches += not e.name.startswith(("Memcpy", "Memset"))
        else:
            host.append((a, b, e.name))
    merged = _merge(device)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    idle = defaultdict(float)
    if merged:
        idle["window edges"] = max(0.0, window_s - (merged[-1][1] - merged[0][0]) * 1e-6)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    host.sort()
    labels = _innermost([(a + b) / 2 for a, b in gaps], host)
    for (a, b), label in zip(gaps, labels):
        idle[label or "host outside CUDA calls"] += (b - a) * 1e-6
    return {"busy_s": busy_s, "launches": launches, "device_ops": _top(by_op),
            "idle_gaps": _top(idle)}


def _innermost(points, events):
    """For each of the sorted ``points``, the name of the latest-starting
    event of the start-sorted ``events`` that contains it, or None."""
    out, heap, i = [], [], 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            heapq.heappush(heap, (-events[i][0], events[i][1], events[i][2]))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out
