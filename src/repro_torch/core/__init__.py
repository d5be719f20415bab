"""Core Radar DataTree data model: the FM-301 schema and the archive."""

from . import fm301
from .datatree import RadarArchive

__all__ = ["RadarArchive", "fm301"]
