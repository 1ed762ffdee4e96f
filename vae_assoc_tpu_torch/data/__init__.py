"""Input data: the UJI loader, the synthetic strokes, the device-side
pipeline and the streamed input."""

from vae_assoc_tpu_torch.data.pipeline import PairedDataset, featurize_pairs
from vae_assoc_tpu_torch.data.stream import prefetch_batches, stream_train
from vae_assoc_tpu_torch.data.synthetic import generate_raw_strokes
from vae_assoc_tpu_torch.data.uji import load_uji_files, parse_uji_text

__all__ = [
    "PairedDataset",
    "featurize_pairs",
    "generate_raw_strokes",
    "load_uji_files",
    "parse_uji_text",
    "prefetch_batches",
    "stream_train",
]
