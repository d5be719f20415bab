"""Model data drawn from the archive: radar scans as LM token sequences."""

from .radar_tokens import DBZ_MAX, DBZ_MIN, RadarTokenDataset, TokenizerSpec

__all__ = ["DBZ_MAX", "DBZ_MIN", "RadarTokenDataset", "TokenizerSpec"]
