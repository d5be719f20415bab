"""Raw2Zarr ETL: raw binary volumes -> transactional Radar DataTree."""

from . import level2
from .feed import LiveFeed
from .generator import StormSimulator, beam_height_m, live_scan_feed
from .pipeline import generate_raw_archive, ingest, IngestReport

__all__ = ["LiveFeed", "StormSimulator", "beam_height_m",
           "generate_raw_archive", "ingest", "IngestReport", "level2",
           "live_scan_feed"]
