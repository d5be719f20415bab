"""Model data: synthetic batches, and radar scans from the archive as LM
token sequences."""

from .batches import input_specs, make_batch
from .radar_tokens import DBZ_MAX, DBZ_MIN, RadarTokenDataset, TokenizerSpec

__all__ = ["DBZ_MAX", "DBZ_MIN", "RadarTokenDataset", "TokenizerSpec",
           "input_specs", "make_batch"]
