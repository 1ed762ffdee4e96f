"""Paired input pipeline on the device (counterpart of vae_assoc_tpu/data/pipeline.py).

Raw padded stroke sequences go to the device once, and both modalities'
features are derived there from the same raw character:

  trajectory branch: arc-length resample → center/scale → flatten
  image branch:      resample → rasterize 28×28 → blur → normalize [0, 1]

Left out until their modules are ported (ROADMAP): per-epoch augmentation,
the RBF trajectory encoding and the UJI loader.
"""

from __future__ import annotations

import numpy as np
import torch

from vae_assoc_tpu_torch.models.networks import cuda_or_raise
from vae_assoc_tpu_torch.ops.rasterize import rasterize_trajectories
from vae_assoc_tpu_torch.ops.resample import normalize_and_flatten


def featurize_pairs(points: torch.Tensor, lengths: torch.Tensor, *,
                    n_timesteps: int = 100, image_size: int = 28,
                    raster_points: int | None = None):
    """[B, max_pts, 2] raw strokes → (images [B, size²] in [0, 1],
    trajectories [B, 2·n_timesteps] in [-1, 1]), on the strokes' device."""
    trajs = normalize_and_flatten(points, lengths, n_timesteps)
    # Rasterize from a denser resample so thin fast strokes stay connected.
    rp = raster_points or max(2 * n_timesteps, 128)
    dense = normalize_and_flatten(points, lengths, rp, flatten=False)
    images = rasterize_trajectories(dense, size=image_size)
    return images, trajs


class PairedDataset:
    """Raw strokes staged on ``device`` once and featurized there; the card
    unless the caller names the CPU (without a GPU ``device="cuda"`` raises).

        ds = PairedDataset.from_synthetic(2000)
        imgs, trajs = ds.features()   # device tensors, ready for train_loop
    """

    def __init__(self, points, lengths, labels=None, *, n_timesteps: int = 100,
                 image_size: int = 28, device="cuda"):
        self.n_timesteps = n_timesteps
        self.image_size = image_size
        self.labels = labels
        self.device = cuda_or_raise(device, "PairedDataset")
        self._points = torch.as_tensor(np.asarray(points, np.float32), device=self.device)
        self._lengths = torch.as_tensor(np.asarray(lengths, np.int64), device=self.device)
        self._features = None

    @classmethod
    def from_synthetic(cls, n_samples: int, *, seed: int = 0, **kw):
        from vae_assoc_tpu_torch.data.synthetic import generate_raw_strokes

        raw = generate_raw_strokes(n_samples, seed=seed)
        return cls(raw["points"], raw["lengths"], raw["labels"], **kw)

    @classmethod
    def from_uji(cls, paths, **kw):
        raise NotImplementedError(
            "PairedDataset.from_uji needs data/uji.py, which is not ported "
            "yet (ROADMAP item 10); use from_synthetic or the JAX package"
        )

    def __len__(self):
        return int(self._points.shape[0])

    def features(self):
        """(images [N, size²], trajectories [N, 2·n_timesteps]) on the
        dataset's device; computed once and cached."""
        if self._features is None:
            with torch.no_grad():
                self._features = featurize_pairs(
                    self._points, self._lengths, n_timesteps=self.n_timesteps,
                    image_size=self.image_size,
                )
        return self._features
