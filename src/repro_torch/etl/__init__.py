"""Archive construction inputs: the deterministic storm simulator."""

from .generator import StormSimulator, beam_height_m

__all__ = ["StormSimulator", "beam_height_m"]
