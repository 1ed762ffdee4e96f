"""Paired input pipeline on the device (counterpart of vae_assoc_tpu/data/pipeline.py).

Raw padded stroke sequences go to the device once, and both modalities'
features are derived there from the same raw character:

  trajectory branch: arc-length resample → center/scale → flatten, or the
                     resampled curve's RBF weights (``traj_encoding="rbf"``)
  image branch:      resample → rasterize 28×28 → blur → normalize [0, 1]

An optional per-sample affine augmentation of the raw strokes comes first,
so both modalities of a pair see the same deformed character.
"""

from __future__ import annotations

import numpy as np
import torch

from vae_assoc_tpu_torch.models.networks import cuda_or_raise
from vae_assoc_tpu_torch.ops.augment import augment_strokes
from vae_assoc_tpu_torch.ops.rasterize import rasterize_trajectories
from vae_assoc_tpu_torch.ops.rbf import fit_rbf, rbf_reconstruct
from vae_assoc_tpu_torch.ops.resample import normalize_and_flatten, unflatten_trajectory


def featurize_pairs(points: torch.Tensor, lengths: torch.Tensor, *,
                    n_timesteps: int = 100, image_size: int = 28,
                    raster_points: int | None = None, traj_encoding: str = "resample",
                    rbf_centers: int = 100, augment=None,
                    generator: torch.Generator | None = None):
    """[B, max_pts, 2] raw strokes → (images [B, size²] in [0, 1],
    trajectory features), on the strokes' device.

    The trajectory features are [B, 2·n_timesteps] in [-1, 1] under
    ``traj_encoding="resample"``, or under ``"rbf"`` the [B, 2·rbf_centers]
    weights of the resampled curve's RBF fit (``ops/rbf.py``).
    ``augment`` (an ``ops.augment.AugmentConfig``) with ``generator``
    deforms the raw strokes first, drawing from the generator."""
    if traj_encoding not in ("resample", "rbf"):
        raise ValueError(f"traj_encoding must be 'resample' or 'rbf', got {traj_encoding!r}")
    if augment is not None:
        if generator is None:
            raise ValueError("augment given but generator is None")
        points = augment_strokes(points, lengths, generator, augment)
    if traj_encoding == "rbf":
        curves = normalize_and_flatten(points, lengths, n_timesteps, flatten=False)
        trajs = fit_rbf(curves, n_centers=rbf_centers)
    else:
        trajs = normalize_and_flatten(points, lengths, n_timesteps)
    # Rasterize from a denser resample so thin fast strokes stay connected.
    rp = raster_points or max(2 * n_timesteps, 128)
    dense = normalize_and_flatten(points, lengths, rp, flatten=False)
    images = rasterize_trajectories(dense, size=image_size)
    return images, trajs


def split_train_val(arrays, val_frac: float, *, seed: int = 0):
    """A seeded held-out split of row-aligned arrays.

    Returns ``(train_arrays, val_arrays, (train_idx, val_idx))``: the index
    arrays (numpy) are the JAX package's permutation of ``range(N)``,
    ``np.random.default_rng(seed).permutation(N)``, split at its last
    ``ceil(N · val_frac)`` rows, so a resumed run holds out the same rows.
    Each array's rows are gathered where it lives (a tensor on its device,
    a numpy array on the host)."""
    if not 0.0 < val_frac < 1.0:
        raise ValueError(f"val_frac must be in (0, 1), got {val_frac}")
    n = int(arrays[0].shape[0])
    for a in arrays[1:]:
        if int(a.shape[0]) != n:
            raise ValueError(
                "split_train_val needs row-aligned arrays; got leading dims "
                f"{[int(a.shape[0]) for a in arrays]}"
            )
    n_val = int(np.ceil(n * val_frac))
    if not 0 < n_val < n:
        raise ValueError(f"val_frac {val_frac} of {n} samples leaves an empty split")
    perm = np.random.default_rng(seed).permutation(n)
    train_idx, val_idx = perm[:-n_val], perm[-n_val:]

    def rows(a, idx):
        if isinstance(a, torch.Tensor):
            return a[torch.as_tensor(idx, device=a.device)]
        return np.asarray(a)[idx]

    train = [rows(a, train_idx) for a in arrays]
    val = [rows(a, val_idx) for a in arrays]
    return train, val, (train_idx, val_idx)


class PairedDataset:
    """Raw strokes staged on ``device`` once and featurized there; the card
    unless the caller names the CPU (without a GPU ``device="cuda"`` raises).

        ds = PairedDataset.from_uji(["UJIpenchars-w01"], traj_encoding="rbf")
        imgs, trajs = ds.features()   # device tensors, ready for train_loop
    """

    def __init__(self, points, lengths, labels=None, *, n_timesteps: int = 100,
                 image_size: int = 28, traj_encoding: str = "resample",
                 rbf_centers: int = 100, device="cuda"):
        self.n_timesteps = n_timesteps
        self.image_size = image_size
        self.traj_encoding = traj_encoding
        self.rbf_centers = rbf_centers
        self.labels = labels
        self.device = cuda_or_raise(device, "PairedDataset")
        self._points = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        self._lengths = torch.as_tensor(lengths, dtype=torch.int64, device=self.device)
        self._features = None

    @property
    def traj_features(self) -> int:
        """The trajectory feature width under this encoding: the trajectory
        modality's arch ``n_input``."""
        return 2 * (self.rbf_centers if self.traj_encoding == "rbf" else self.n_timesteps)

    @classmethod
    def from_synthetic(cls, n_samples: int, *, seed: int = 0, **kw):
        from vae_assoc_tpu_torch.data.synthetic import generate_raw_strokes

        raw = generate_raw_strokes(n_samples, seed=seed)
        return cls(raw["points"], raw["lengths"], raw["labels"], **kw)

    @classmethod
    def from_uji(cls, paths, *, charset=None, max_points: int = 256, **kw):
        """UJI Pen Characters v2 files (``data/uji.py``) on ``device``."""
        from vae_assoc_tpu_torch.data.uji import load_uji_files

        raw = load_uji_files(paths, charset=charset, max_points=max_points)
        return cls(raw["points"], raw["lengths"], raw["labels"], **kw)

    def __len__(self):
        return int(self._points.shape[0])

    def features(self, *, augment=None, generator: torch.Generator | None = None):
        """(images [N, size²], trajectory features [N, traj_features]) on the
        dataset's device; the clean result is computed once and cached.

        With ``augment`` (an ``ops.augment.AugmentConfig``) and ``generator``
        the raw strokes are deformed first and nothing is cached: each call
        draws a fresh view (``train_loop``'s ``refresh_data`` hook)."""
        if augment is not None:
            return self._featurize(augment, generator)
        if generator is not None:
            raise ValueError(
                "generator given without augment (an AugmentConfig): pass both; a "
                "generator alone would silently return the cached clean features"
            )
        if self._features is None:
            self._features = self._featurize(None, None)
        return self._features

    def subset(self, idx) -> "PairedDataset":
        """A dataset over rows ``idx`` with the same featurization, on the
        same device (per-epoch augmentation then featurizes only these)."""
        idx = np.asarray(idx)
        rows = torch.as_tensor(idx, device=self.device)
        return PairedDataset(
            self._points[rows], self._lengths[rows],
            None if self.labels is None else np.asarray(self.labels)[idx],
            n_timesteps=self.n_timesteps, image_size=self.image_size,
            traj_encoding=self.traj_encoding, rbf_centers=self.rbf_centers,
            device=self.device,
        )

    def _featurize(self, augment, generator):
        with torch.no_grad():
            return featurize_pairs(
                self._points, self._lengths, n_timesteps=self.n_timesteps,
                image_size=self.image_size, traj_encoding=self.traj_encoding,
                rbf_centers=self.rbf_centers, augment=augment, generator=generator,
            )

    def decode_trajectories(self, trajs=None):
        """Trajectory features → [N, n_timesteps, 2] curves, inverting this
        dataset's encoding (model-generated features too); default: the
        dataset's own clean features."""
        if trajs is None:
            trajs = self.features()[1]
        trajs = torch.as_tensor(trajs, dtype=torch.float32, device=self.device)
        if self.traj_encoding == "rbf":
            return rbf_reconstruct(trajs, self.n_timesteps)
        return unflatten_trajectory(trajs)

    def trajectories_2d(self):
        """[N, T, 2] normalized trajectory curves (for plots and robots)."""
        return self.decode_trajectories()
