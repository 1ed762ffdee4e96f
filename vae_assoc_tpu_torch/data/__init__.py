"""Input data: the synthetic stroke dataset and the device-side pipeline."""

from vae_assoc_tpu_torch.data.pipeline import PairedDataset, featurize_pairs
from vae_assoc_tpu_torch.data.synthetic import generate_raw_strokes

__all__ = ["PairedDataset", "featurize_pairs", "generate_raw_strokes"]
