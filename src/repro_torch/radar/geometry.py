"""Radar beam geometry (4/3-earth model) shared by science workflows.

Forward model: antenna (azimuth, slant range, elevation) -> beam height,
ground range, (lat, lon).  Inverse model: (lat, lon) -> (azimuth, ground
range), which :mod:`repro_torch.radar.grid` uses to precompute
polar->Cartesian gate maps.  Host-side numpy in float64, a copy of the
reference package's module so both give bitwise-equal maps.

Two lat/lon formulations coexist:

* ``method="spherical"`` (default): exact great-circle destination /
  inverse formulas on the Earth sphere.  Valid at any latitude and across
  the antimeridian.
* ``method="equirect"``: the small-offset equirectangular approximation
  (one ``cos(site_lat)`` metres-per-degree correction), whose error grows
  with ``ground_range * tan(lat)``.

Both methods wrap longitudes into ``[-180, 180)``.
"""

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


def ground_range_m(range_m, elev_deg: float):
    """Great-circle distance along the surface to each gate."""
    el = np.deg2rad(elev_deg)
    r = np.asarray(range_m, dtype=np.float64)
    h = beam_height_m(r, elev_deg)
    return KE * EARTH_RADIUS_M * np.arcsin(
        r * np.cos(el) / (KE * EARTH_RADIUS_M + h)
    )


def wrap_lon(lon_deg):
    """Wrap longitudes into the canonical ``[-180, 180)`` interval."""
    return (np.asarray(lon_deg, dtype=np.float64) + 180.0) % 360.0 - 180.0


def gate_latlon(site_lat: float, site_lon: float, az_deg, range_m,
                elev_deg: float, *, method: str = "spherical"):
    """(lat, lon) of gates; see module docstring for the two methods."""
    s = np.asarray(ground_range_m(range_m, elev_deg))
    az = np.deg2rad(np.asarray(az_deg))
    if method == "spherical":
        # great-circle destination point: exact on the sphere, so valid
        # at high latitudes and across the antimeridian
        lat1 = np.deg2rad(site_lat)
        d = s / EARTH_RADIUS_M  # angular distance
        sin_lat2 = (np.sin(lat1) * np.cos(d)
                    + np.cos(lat1) * np.sin(d) * np.cos(az))
        lat2 = np.arcsin(np.clip(sin_lat2, -1.0, 1.0))
        dlon = np.arctan2(np.sin(az) * np.sin(d) * np.cos(lat1),
                          np.cos(d) - np.sin(lat1) * sin_lat2)
        return np.rad2deg(lat2), wrap_lon(site_lon + np.rad2deg(dlon))
    if method == "equirect":
        dn = s * np.cos(az)
        de = s * np.sin(az)
        lat = site_lat + np.rad2deg(dn / EARTH_RADIUS_M)
        lon = site_lon + np.rad2deg(
            de / (EARTH_RADIUS_M * np.cos(np.deg2rad(site_lat)))
        )
        return lat, wrap_lon(lon)
    raise ValueError(f"unknown method {method!r} (spherical|equirect)")


def reach_box_deg(site_lat: float, reach_m: float):
    """Degree half-extents of a site's reach box.

    Half-extents ``(dlat, dlon)`` in degrees of a lat/lon box
    containing every point within ``reach_m`` ground distance of a site
    (the cos-lat metres-per-degree factor is floored so polar sites stay
    finite).  Shared by the catalog's coverage bbox and the gridding
    default grids so the two can never drift apart."""
    dlat = float(np.rad2deg(reach_m / EARTH_RADIUS_M))
    coslat = max(np.cos(np.deg2rad(site_lat)), 1e-6)
    dlon = float(np.rad2deg(reach_m / (EARTH_RADIUS_M * coslat)))
    return dlat, dlon


def latlon_to_polar(site_lat: float, site_lon: float, lat, lon):
    """Inverse of :func:`gate_latlon`: (azimuth deg, ground range m).

    Exact great-circle inverse (haversine distance + initial bearing).
    Azimuth is degrees clockwise from north in ``[0, 360)``; longitude
    inputs may be in any 360-degree branch (they are wrapped).
    """
    lat1 = np.deg2rad(site_lat)
    lat2 = np.deg2rad(np.asarray(lat, dtype=np.float64))
    dlon = np.deg2rad(wrap_lon(np.asarray(lon, dtype=np.float64) - site_lon))
    sin_half_dlat = np.sin((lat2 - lat1) / 2.0)
    sin_half_dlon = np.sin(dlon / 2.0)
    a = (sin_half_dlat**2
         + np.cos(lat1) * np.cos(lat2) * sin_half_dlon**2)
    ground = 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))
    az = np.arctan2(
        np.sin(dlon) * np.cos(lat2),
        np.cos(lat1) * np.sin(lat2) - np.sin(lat1) * np.cos(lat2) * np.cos(dlon),
    )
    return np.rad2deg(az) % 360.0, ground
