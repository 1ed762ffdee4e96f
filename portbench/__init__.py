"""The benchmark of vae_assoc_tpu_torch on an NVIDIA H100 (see run.py)."""
