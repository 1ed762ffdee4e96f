"""vae_assoc_tpu_torch — the PyTorch and CUDA port of vae_assoc_tpu.

The serving path of the associative multimodal VAE on an NVIDIA GPU: typed
configs (the JAX package's JSON schema), the MLP towers as torch modules in
the reference parameter layout, hand-written Hopper kernels for the fused
encoder and decoder stacks, a bucketing `serve.Predictor` with its
`MicroBatcher`, and the stdlib HTTP front end `serve_http`. The JAX package
`vae_assoc_tpu` is the reference that every part is tested against; this
package imports torch and never jax.

Importing the package sets the precision policy (models/networks.py).
"""

from vae_assoc_tpu_torch.version import __version__
from vae_assoc_tpu_torch.configs import (
    AssocConfig,
    ModalityConfig,
    TrainConfig,
    baseline_config,
    default_image_arch,
    default_traj_arch,
)

__all__ = [
    "__version__",
    "AssocConfig",
    "ModalityConfig",
    "TrainConfig",
    "baseline_config",
    "default_image_arch",
    "default_traj_arch",
]
