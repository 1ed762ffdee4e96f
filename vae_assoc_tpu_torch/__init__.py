"""vae_assoc_tpu_torch — the PyTorch and CUDA port of vae_assoc_tpu.

The associative multimodal VAE on an NVIDIA GPU: typed configs (the JAX
package's JSON schema), the towers as torch modules in the reference
parameter layout, hand-written Hopper kernels for every Pallas kernel of
the JAX package, the train step and loops, the reference's class API
(`VariationalAutoencoder`, `AssocVariationalAutoEncoder`, `train`) with
whole-state checkpoints, evaluation (`train.eval`, the `evaluate` CLI), a
bucketing `serve.Predictor` with its `MicroBatcher`, the stdlib HTTP
front end `serve_http`, and `export` (self-contained `torch.export`
serving artifacts). The JAX package
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
from vae_assoc_tpu_torch.api import (
    AssocVariationalAutoEncoder,
    VariationalAutoencoder,
    train,
)

__all__ = [
    "__version__",
    "AssocConfig",
    "ModalityConfig",
    "TrainConfig",
    "baseline_config",
    "default_image_arch",
    "default_traj_arch",
    "VariationalAutoencoder",
    "AssocVariationalAutoEncoder",
    "train",
]
