"""Training and evaluation plots (counterpart of vae_assoc_tpu/utils/viz.py).

Reconstruction grids, generated trajectories drawn over their paired
images, a 2-D latent scatter, the latent-manifold canvas and the
class-conditional grid, each a function returning a matplotlib Figure
(the caller saves or shows it). Inputs may be tensors on any device or
numpy arrays; they are moved to the host. matplotlib is imported only
when a plot is made, so the package does not need it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def reconstruction_grid(x, x_recon, *, image_size: int = 28, n: int = 8):
    """Top row originals, bottom row reconstructions ([N, size²] in [0,1])."""
    plt = _plt()
    x = _host(x)[:n]
    r = _host(x_recon)[:n]
    n = min(x.shape[0], r.shape[0])  # tolerate mismatched row counts
    fig, axes = plt.subplots(2, n, figsize=(1.2 * n, 2.6))
    # n == 1 gives a shape-(2,) axes vector; reshape (not atleast_2d, which
    # would make it (1, 2) and break axes[1, 0]).
    axes = np.asarray(axes).reshape(2, n)
    for i in range(n):
        for row, img in ((0, x[i]), (1, r[i])):
            ax = axes[row, i]
            ax.imshow(img.reshape(image_size, image_size), cmap="gray_r",
                      vmin=0, vmax=1)
            ax.set_xticks([])
            ax.set_yticks([])
    axes[0, 0].set_ylabel("input", fontsize=9)
    axes[1, 0].set_ylabel("recon", fontsize=9)
    fig.tight_layout()
    return fig


def trajectories_over_images(
    images, trajs_flat, *, image_size: int = 28, n: int = 8, n_dims: int = 2
):
    """Generated trajectories drawn over their paired character images.

    trajs_flat: [N, T*2] normalized to [-1,1]² (the pipeline convention).
    The cross-modal showcase: image→trajectory 'writing'.
    """
    plt = _plt()
    imgs = _host(images)[:n]
    tr = _host(trajs_flat)[:n]
    n = min(imgs.shape[0], tr.shape[0])  # fewer samples than requested
    imgs, tr = imgs[:n], tr[:n].reshape(n, -1, n_dims)
    fig, axes = plt.subplots(1, n, figsize=(1.4 * n, 1.6))
    axes = np.atleast_1d(axes)
    margin = 1.5
    scale = (image_size - 1 - 2 * margin) / 2.0
    for i, ax in enumerate(axes[:n]):
        ax.imshow(imgs[i].reshape(image_size, image_size), cmap="gray_r",
                  vmin=0, vmax=1)
        px = margin + (tr[i, :, 0] + 1.0) * scale
        py = margin + (1.0 - tr[i, :, 1]) * scale
        ax.plot(px, py, lw=1.5)
        ax.scatter(px[:1], py[:1], s=12)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    return fig


def latent_scatter(z, labels: Optional[Sequence[int]] = None, *, dims=(0, 1)):
    """2-D scatter of latent means, colored by class label when given."""
    plt = _plt()
    z = _host(z)
    fig, ax = plt.subplots(figsize=(5, 5))
    c = None if labels is None else _host(labels)
    sc = ax.scatter(z[:, dims[0]], z[:, dims[1]], c=c, cmap="tab10", s=8)
    if labels is not None:
        fig.colorbar(sc, ax=ax, label="class")
    ax.set_xlabel(f"z[{dims[0]}]")
    ax.set_ylabel(f"z[{dims[1]}]")
    fig.tight_layout()
    return fig


def latent_manifold(
    decode_fn,
    *,
    image_size: int = 28,
    grid_n: int = 15,
    dims=(0, 1),
    n_z: int = 20,
    span: float = 2.0,
    base=None,
):
    """The latent-manifold canvas: a grid_n × grid_n sweep over two latent
    dimensions, each cell decoded to an image and tiled into one canvas.

    decode_fn: z [B, n_z] → images [B, image_size²] in [0, 1] (e.g.
    ``lambda z: assoc.generate(params, z, cfg, "image")`` or the api/
    Predictor `generate` verb — any batch-capable decoder; conditional
    models close over their cond). The swept dims take a uniform grid in
    [−span, span] (≈±2σ of the N(0, I) prior); the remaining latent
    coordinates come from `base` (default zeros — the prior mean).
    ONE decode call for the whole canvas.
    """
    plt = _plt()
    lin = np.linspace(-span, span, grid_n, dtype=np.float32)
    base = (np.zeros(n_z, np.float32) if base is None
            else _host(base).astype(np.float32))
    if base.shape != (n_z,):
        raise ValueError(f"base must be [{n_z}], got {base.shape}")
    z = np.tile(base, (grid_n * grid_n, 1))
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    z[:, dims[0]] = gx.ravel()
    z[:, dims[1]] = -gy.ravel()  # canvas rows top→bottom = dim decreasing
    imgs = _host(decode_fn(z)).reshape(grid_n, grid_n, image_size, image_size)
    canvas = imgs.transpose(0, 2, 1, 3).reshape(grid_n * image_size,
                                                grid_n * image_size)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(canvas, cmap="gray_r", vmin=0, vmax=1)
    ax.set_xlabel(f"z[{dims[0]}] in [-{span}, {span}]")
    ax.set_ylabel(f"z[{dims[1]}] in [-{span}, {span}]")
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout()
    return fig


def class_generation_grid(
    decode_fn,
    n_classes: int,
    *,
    samples_per_class: int = 8,
    image_size: int = 28,
):
    """Conditional-generation showcase: rows = classes, columns = prior
    samples — p(x | c) with NO exemplar input (the conditional VAE's
    product feature).

    decode_fn: labels [B] int32 → images [B, image_size²] in [0, 1] —
    the caller closes over its model and z-draw policy (e.g.
    ``lambda lab: assoc.generate(params, z_draws, cfg, "image",
    cond=lab)``). For a column-comparable figure, draw
    ``samples_per_class`` z rows once and tile them per class so column j
    varies only by condition. ONE decode call total.
    """
    plt = _plt()
    labels = np.repeat(np.arange(n_classes), samples_per_class).astype(np.int32)
    imgs = _host(decode_fn(labels)).reshape(
        n_classes, samples_per_class, image_size, image_size
    )
    canvas = imgs.transpose(0, 2, 1, 3).reshape(
        n_classes * image_size, samples_per_class * image_size
    )
    fig, ax = plt.subplots(figsize=(samples_per_class * 0.8, n_classes * 0.8))
    ax.imshow(canvas, cmap="gray_r", vmin=0, vmax=1)
    ax.set_ylabel("class (condition)")
    ax.set_xlabel("prior samples")
    ax.set_xticks([])
    ax.set_yticks([(i + 0.5) * image_size for i in range(n_classes)],
                  [str(i) for i in range(n_classes)])
    fig.tight_layout()
    return fig
