"""Core Radar DataTree data model (the paper's primary contribution)."""

from . import fm301
from .datatree import DataTree, RadarArchive, Variable, tree_from_session

__all__ = ["DataTree", "RadarArchive", "Variable", "fm301", "tree_from_session"]
