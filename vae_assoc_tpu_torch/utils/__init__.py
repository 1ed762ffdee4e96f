"""Utilities of the PyTorch port."""

from vae_assoc_tpu_torch.utils.compile_cache import enable_compile_cache
from vae_assoc_tpu_torch.utils.logging import MetricsLogger, read_jsonl

__all__ = ["MetricsLogger", "enable_compile_cache", "read_jsonl"]
# checkpoint and viz are imported lazily by callers (torch.save and
# matplotlib are heavier than the logging core).
