"""Shape-bucketing contract shared by every serving surface.

XLA compiles one program per concrete shape, so serving pads request
batches up to the nearest power-of-two bucket (bounded compile set) and
chunks anything beyond ``MAX_BUCKET`` into multiple device calls. This
lives in its own dependency-free module (numpy only — no model code) so
AOT-exported artifacts (:mod:`vae_assoc_tpu.export`) bucket identically
to the live :class:`vae_assoc_tpu.serve.Predictor`: the pad/chunk/warmup
logic exists ONCE here, and both surfaces call it with their own
endpoint callables, so the contract cannot drift between them.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

MAX_BUCKET = 4096


def _bucket(n: int) -> int:
    """Smallest power of two >= n, capped at MAX_BUCKET."""
    b = 1
    while b < n and b < MAX_BUCKET:
        b *= 2
    return b


def pad_rows(x: np.ndarray):
    """Zero-pad rows up to the bucket size. Returns (padded, true_n)."""
    n = x.shape[0]
    assert n <= MAX_BUCKET  # callers chunk before padding
    b = _bucket(n)
    if b == n:
        return x, n
    return np.concatenate([x, np.zeros((b - n,) + x.shape[1:], x.dtype)], 0), n


def normalize_cond(cond, n_cond: int, batch: int) -> np.ndarray:
    """Serving-side condition normalizer (conditional models, n_cond > 0):
    int labels [B] → one-hot; float [B, n_cond] passes through as fp32.
    Lives here (numpy-only) so `serve.Predictor` and
    `export.ExportedPredictor` normalize identically."""
    if cond is None:
        raise ValueError(
            f"conditional model (n_cond={n_cond}): every request needs "
            "`cond` (int labels [B] or one-hot [B, n_cond])"
        )
    c = np.asarray(cond)
    if c.ndim == 1:
        # 1-D means integer class labels; silently truncating float values
        # (e.g. a client sending soft scores in the wrong shape) would
        # one-hot classes the caller never intended.
        if not np.issubdtype(c.dtype, np.integer):
            if c.size and not np.all(np.mod(c, 1) == 0):
                raise ValueError(
                    "1-D cond must be integer class labels; got float "
                    f"values {c[:4]!r}... — send one-hot [B, {n_cond}] rows "
                    "for soft conditions"
                )
        lab = c.astype(np.int64)
        if lab.size and (lab.min() < 0 or lab.max() >= n_cond):
            raise ValueError(
                f"labels out of range [0, {n_cond}): "
                f"[{lab.min()}, {lab.max()}]"
            )
        c = np.eye(n_cond, dtype=np.float32)[lab]
    if c.ndim != 2 or c.shape[1] != n_cond:
        raise ValueError(
            f"cond must be [B] labels or [B, {n_cond}]; got {c.shape}"
        )
    if c.shape[0] != batch:
        raise ValueError(f"cond batch {c.shape[0]} != request batch {batch}")
    return c.astype(np.float32)


def check_cond(cond, n_cond: int, batch: int):
    """THE serving-side condition gate, shared by `serve.Predictor`,
    `export.ExportedPredictor`, and `serve_http.ModelServer` (so the three
    surfaces cannot drift): unconditional models reject a stray cond,
    conditional models require + normalize one."""
    if n_cond == 0:
        if cond is not None:
            raise ValueError("model is unconditional; drop `cond`")
        return None
    return normalize_cond(cond, n_cond, batch)


def chunked_cond_call(call2: Callable, x, cond) -> np.ndarray:
    """`chunked_call` for a two-input (x, cond) endpoint; cond=None routes
    to the single-input path. Shared by serve.Predictor and
    export.ExportedPredictor's conditional endpoints (one pattern, not
    four copies)."""
    if cond is None:
        return chunked_call(lambda xp: call2(xp, None), x)
    (out,) = chunked_multi_call(
        lambda ps: (call2(ps[0], ps[1]),), [np.asarray(x), cond]
    )
    return out


def chunked_call(call: Callable, x) -> np.ndarray:
    """Run a single-input row-wise endpoint at any batch size.

    Batches larger than ``MAX_BUCKET`` are split into ``MAX_BUCKET``-row
    calls and re-concatenated — a serving front end must absorb oversize
    requests, not 500 on them. Each chunk hits the already-warm largest
    bucket, so no new compiles happen; smaller batches pad up to their
    bucket and the padding is sliced off the result.
    """
    x = np.asarray(x)
    if x.shape[0] > MAX_BUCKET:
        return np.concatenate(
            [chunked_call(call, x[lo:lo + MAX_BUCKET])
             for lo in range(0, x.shape[0], MAX_BUCKET)], 0
        )
    xp, n = pad_rows(x)
    return np.asarray(call(xp))[:n]


def chunked_multi_call(call: Callable, xs: Sequence[np.ndarray]):
    """`chunked_call` for endpoints taking a list of row-aligned arrays
    (one per modality) and returning a tuple of row-aligned outputs."""
    xs = [np.asarray(x) for x in xs]
    n = xs[0].shape[0]
    if n > MAX_BUCKET:
        parts = [
            chunked_multi_call(call, [x[lo:lo + MAX_BUCKET] for x in xs])
            for lo in range(0, n, MAX_BUCKET)
        ]
        return tuple(np.concatenate(p, 0) for p in zip(*parts))
    padded = [pad_rows(x) for x in xs]
    outs = call([p for p, _ in padded])
    return tuple(np.asarray(o)[:n] for o in outs)


def warmup_endpoints(
    predictor,
    cfg,
    buckets: Sequence[int] = (64, 256, 1024),
    *,
    all_endpoints: bool = False,
) -> None:
    """Pre-compile a predictor's endpoints for the given buckets.

    Works on any object with the serving verb set (`Predictor`,
    `ExportedPredictor`): compiles every cross_generate direction per
    bucket; ``all_endpoints=True`` also compiles transform and generate.
    Compilation is keyed on shapes only, so zero-filled probes suffice.
    """
    k = len(cfg.modalities)
    n_z = cfg.modalities[0].arch["n_z"]
    n_c = getattr(cfg, "n_cond", 0)
    for b in buckets:
        xs = [np.zeros((b, m.arch["n_input"]), np.float32)
              for m in cfg.modalities]
        # Conditional models: compile keys on shapes only, so an all-zero
        # (soft) condition probe warms the same programs real requests hit.
        ckw = {"cond": np.zeros((b, n_c), np.float32)} if n_c else {}
        for i in range(k):
            for j in range(k):
                predictor.cross_generate(xs[i], i, j, **ckw)
        if all_endpoints:
            predictor.transform(xs + list(ckw.values()))
            z = np.zeros((b, n_z), np.float32)
            for j in range(k):
                predictor.generate(z, j, **ckw)
