"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain torch twin.

The sources live in ``csrc/`` and are built at first use (``_build.py``).
A wrapper runs its plain twin for a CPU tensor and launches its kernel, or
raises, for a CUDA tensor. ``LAUNCHES`` counts the serving kernels'
launches, ``launch_counts()`` every kernel's, and ``reset_launches()``
zeroes them all.
"""

from vae_assoc_tpu_torch.kernels._launches import snapshot as launch_counts
from vae_assoc_tpu_torch.kernels.mlp import (
    LAUNCHES,
    decode_mlp_fused,
    encode_mlp_fused,
    reset_launches,
)

__all__ = [
    "LAUNCHES",
    "decode_mlp_fused",
    "encode_mlp_fused",
    "launch_counts",
    "reset_launches",
]
