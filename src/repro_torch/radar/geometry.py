"""Radar beam geometry (4/3-earth model) shared by science workflows."""

from __future__ import annotations

import numpy as np

EARTH_RADIUS_M = 6371000.0
KE = 4.0 / 3.0


def beam_height_m(range_m, elev_deg: float, alt_m: float = 0.0):
    """Beam centre height above radar level (Doviak & Zrnić eq. 2.28b)."""
    el = np.deg2rad(elev_deg)
    r = np.asarray(range_m, dtype=np.float64)
    return (
        np.sqrt(r**2 + (KE * EARTH_RADIUS_M) ** 2
                + 2.0 * r * KE * EARTH_RADIUS_M * np.sin(el))
        - KE * EARTH_RADIUS_M
        + alt_m
    )
