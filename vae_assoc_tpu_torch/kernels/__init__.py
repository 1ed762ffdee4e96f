"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain torch twin.

The sources live in ``csrc/`` and are built at first use (``_build.py``).
A wrapper runs its plain twin for a CPU tensor and launches its kernel, or
raises, for a CUDA tensor; ``LAUNCHES`` counts the launches.
"""

from vae_assoc_tpu_torch.kernels.mlp import (
    LAUNCHES,
    decode_mlp_fused,
    encode_mlp_fused,
    reset_launches,
)

__all__ = ["LAUNCHES", "decode_mlp_fused", "encode_mlp_fused", "reset_launches"]
