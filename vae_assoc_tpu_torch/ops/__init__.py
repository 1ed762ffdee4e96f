"""Plain torch operators: losses, samplers and the stroke featurizers."""

from vae_assoc_tpu_torch.ops.losses import (
    assoc_loss,
    bernoulli_recon,
    gaussian_recon,
    kl_divergence,
)
from vae_assoc_tpu_torch.ops.rasterize import rasterize_trajectories
from vae_assoc_tpu_torch.ops.rbf import fit_rbf, rbf_basis, rbf_reconstruct
from vae_assoc_tpu_torch.ops.resample import (
    arc_length_resample,
    batch_resample,
    normalize_and_flatten,
    unflatten_trajectory,
    validate_strokes,
)
from vae_assoc_tpu_torch.ops.sampling import reparameterize, sample_eps

__all__ = [
    "bernoulli_recon",
    "gaussian_recon",
    "kl_divergence",
    "assoc_loss",
    "reparameterize",
    "sample_eps",
    "arc_length_resample",
    "batch_resample",
    "normalize_and_flatten",
    "unflatten_trajectory",
    "validate_strokes",
    "rasterize_trajectories",
    "fit_rbf",
    "rbf_reconstruct",
    "rbf_basis",
]
