"""Procedural synthetic pen-character dataset (test/CI fixture).

SURVEY.md §4.5: a checked-in-free synthetic mini-dataset — procedurally
generated stroke "characters" with rasterizations — so tests and benches
never need the real UJI download. Each class is a smooth parametric curve
(Catmull-Rom spline through class-specific control points); samples get
random affine jitter and non-uniform time warping (so the arc-length
resampler actually has work to do). Output is the *raw* modality pair
source: padded variable-length point sequences + lengths, which the
device pipeline turns into (image, trajectory) features.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Control points (x, y in roughly [-1,1]²) for 10 synthetic "characters".
_CLASS_CONTROL_POINTS = [
    # 0: circle-ish
    [(0.0, 0.9), (0.8, 0.3), (0.6, -0.7), (0.0, -0.9), (-0.6, -0.7), (-0.8, 0.3), (0.0, 0.9)],
    # 1: vertical stroke with serif
    [(-0.2, 0.7), (0.1, 0.9), (0.1, -0.9), (0.1, -0.9)],
    # 2: zigzag "z"
    [(-0.7, 0.8), (0.7, 0.8), (-0.7, -0.8), (0.7, -0.8)],
    # 3: double bump "3"
    [(-0.5, 0.8), (0.6, 0.6), (0.0, 0.1), (0.6, -0.4), (-0.5, -0.8)],
    # 4: angle + bar
    [(0.3, 0.9), (-0.6, -0.1), (0.7, -0.1), (0.3, 0.4), (0.3, -0.9)],
    # 5: flag + hook
    [(0.6, 0.9), (-0.5, 0.9), (-0.5, 0.1), (0.4, 0.2), (0.6, -0.5), (-0.4, -0.9)],
    # 6: descending spiral
    [(0.5, 0.9), (-0.5, 0.3), (-0.4, -0.7), (0.4, -0.8), (0.5, -0.2), (-0.3, -0.1)],
    # 7: roof + diagonal
    [(-0.7, 0.8), (0.7, 0.8), (-0.1, -0.9)],
    # 8: figure-eight
    [(0.0, 0.9), (-0.6, 0.5), (0.5, -0.4), (0.0, -0.9), (-0.5, -0.4), (0.6, 0.5), (0.0, 0.9)],
    # 9: loop + tail
    [(0.5, 0.6), (-0.4, 0.9), (-0.5, 0.2), (0.5, 0.5), (0.4, -0.9)],
]


def _catmull_rom(ctrl: np.ndarray, n: int) -> np.ndarray:
    """Sample a Catmull-Rom spline through `ctrl` at n points (vectorized)."""
    p = np.concatenate([ctrl[:1], ctrl, ctrl[-1:]], axis=0)  # clamp ends
    m = len(ctrl) - 1  # segments
    ts = np.linspace(0, m, n, endpoint=True)
    seg = np.clip(ts.astype(int), 0, m - 1)
    u = (ts - seg)[:, None]
    p0, p1, p2, p3 = p[seg], p[seg + 1], p[seg + 2], p[seg + 3]
    return 0.5 * (
        (2 * p1)
        + (-p0 + p2) * u
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * u * u
        + (-p0 + 3 * p1 - 3 * p2 + p3) * u**3
    )


def generate_raw_strokes(
    n_samples: int,
    *,
    n_classes: int = 10,
    max_points: int = 160,
    min_points: int = 40,
    noise: float = 0.02,
    seed: int = 0,
):
    """Generate padded raw stroke sequences.

    Returns dict with
      points:  [N, max_points, 2] float32, padded past each length
      lengths: [N] int32, number of valid points
      labels:  [N] int32, class id
    Point counts and spacing vary per sample: a random time-warp makes the
    raw points non-uniform along the curve (exercising arc-length
    resampling), and per-sample affine jitter (rotation/scale/shear/shift)
    plus Gaussian noise differentiate instances.
    """
    assert 1 <= n_classes <= len(_CLASS_CONTROL_POINTS)
    rng = np.random.default_rng(seed)
    points = np.zeros((n_samples, max_points, 2), np.float32)
    lengths = np.empty((n_samples,), np.int32)
    labels = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
    # Base curves are class-constant: compute each once, not per sample.
    base_curves = [
        _catmull_rom(np.asarray(c, np.float64), 4 * max_points)
        for c in _CLASS_CONTROL_POINTS[:n_classes]
    ]
    for i in range(n_samples):
        n_pts = int(rng.integers(min_points, max_points + 1))
        # Non-uniform sampling: warp parameter speed with a random power.
        base = base_curves[labels[i]]
        warp = np.linspace(0, 1, n_pts) ** rng.uniform(0.6, 1.6)
        idx = np.clip((warp * (len(base) - 1)).astype(int), 0, len(base) - 1)
        curve = base[idx]
        # Affine jitter.
        ang = rng.normal(0, 0.12)
        sc = rng.uniform(0.85, 1.1)
        shear = rng.normal(0, 0.08)
        rot = np.array(
            [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
        )
        aff = rot @ np.array([[sc, shear], [0.0, sc]])
        curve = curve @ aff.T + rng.normal(0, 0.05, size=(1, 2))
        curve = curve + rng.normal(0, noise, size=curve.shape)
        points[i, :n_pts] = curve.astype(np.float32)
        # Pad with the final point (pipeline masks by length anyway).
        points[i, n_pts:] = curve[-1]
        lengths[i] = n_pts
    return {"points": points, "lengths": lengths, "labels": labels}
