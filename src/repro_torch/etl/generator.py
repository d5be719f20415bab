"""Synthetic storm-field generator producing physically structured moments.

Real NEXRAD Level-II granules are replaced by a deterministic simulator whose output has the statistical structure the
paper's workflows exercise: convective cells advecting with the mean wind,
a stratiform background, a melting-layer bright band (so QVPs show the
classic signature), correlated polarimetric fields, and gate-level noise.
Everything is a pure function of (seed, time, sweep geometry), and the
arithmetic is the reference package's, so both packages generate
bitwise-identical volumes from the same seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from ..core import fm301

EARTH_RADIUS_M = 6371000.0
KE = 4.0 / 3.0  # effective earth radius factor


def beam_height_m(range_m: np.ndarray, elev_deg: float, alt_m: float = 0.0):
    """Standard 4/3-earth beam height above radar level."""
    el = np.deg2rad(elev_deg)
    r = np.asarray(range_m, dtype=np.float64)
    return (
        np.sqrt(r**2 + (KE * EARTH_RADIUS_M) ** 2
                + 2 * r * KE * EARTH_RADIUS_M * np.sin(el))
        - KE * EARTH_RADIUS_M
        + alt_m
    )


@dataclass
class Cell:
    """One synthetic storm cell (position, motion, intensity, extent)."""
    x0: float          # initial position east, m
    y0: float          # initial position north, m
    vx: float          # advection, m/s
    vy: float
    peak_dbz: float
    radius_m: float
    top_m: float       # echo-top height
    growth: float      # intensity modulation frequency


class StormSimulator:
    """Deterministic multi-cell storm + stratiform field."""

    def __init__(self, seed: int = 0, n_cells: int = 6,
                 melting_layer_m: float = 3200.0):
        rng = np.random.default_rng(seed)
        self.seed = seed
        self.melting_layer_m = melting_layer_m
        self.wind = (float(rng.uniform(5, 15)), float(rng.uniform(-5, 5)))
        self.cells = [
            Cell(
                x0=float(rng.uniform(-80e3, 80e3)),
                y0=float(rng.uniform(-80e3, 80e3)),
                vx=self.wind[0] + float(rng.normal(0, 2)),
                vy=self.wind[1] + float(rng.normal(0, 2)),
                peak_dbz=float(rng.uniform(42, 62)),
                radius_m=float(rng.uniform(4e3, 12e3)),
                top_m=float(rng.uniform(8e3, 14e3)),
                growth=float(rng.uniform(1e-4, 6e-4)),
            )
            for _ in range(n_cells)
        ]

    # -- geometry ------------------------------------------------------
    @staticmethod
    def _polar_grid(n_az: int, n_gates: int, gate_m: float):
        az = (np.arange(n_az, dtype=np.float64) + 0.5) * (360.0 / n_az)
        rng_m = (np.arange(n_gates, dtype=np.float64) + 0.5) * gate_m
        az_r = np.deg2rad(az)[:, None]
        x = rng_m[None, :] * np.sin(az_r)
        y = rng_m[None, :] * np.cos(az_r)
        return az, rng_m, x, y

    # -- moments -------------------------------------------------------
    def moments(
        self,
        t: float,
        elev_deg: float,
        n_az: int,
        n_gates: int,
        gate_m: float,
    ) -> Dict[str, np.ndarray]:
        """All polarimetric moments for one sweep at time ``t`` (seconds)."""
        az, rng_m, x, y = self._polar_grid(n_az, n_gates, gate_m)
        h = beam_height_m(rng_m, elev_deg)[None, :]  # (1, gates)

        # convective cells (Gaussian in plan view, capped by echo top)
        dbz = np.full((n_az, n_gates), -12.0)
        for c in self.cells:
            cx = c.x0 + c.vx * t
            cy = c.y0 + c.vy * t
            # wrap cells inside the 160 km domain so long archives stay busy
            cx = (cx + 80e3) % 160e3 - 80e3
            cy = (cy + 80e3) % 160e3 - 80e3
            amp = c.peak_dbz * (0.75 + 0.25 * math.sin(c.growth * t))
            d2 = (x - cx) ** 2 + (y - cy) ** 2
            vert = np.clip(1.0 - h / c.top_m, 0.0, 1.0)
            dbz = np.maximum(dbz, amp * np.exp(-d2 / (2 * c.radius_m**2)) * vert)

        # stratiform background with bright band at the melting layer
        strat = 18.0 * np.exp(-((h - 0.6 * self.melting_layer_m) / 4000.0) ** 2)
        bright = 7.0 * np.exp(-((h - self.melting_layer_m) / 350.0) ** 2)
        dbz = np.maximum(dbz, strat + bright)

        # gate noise, deterministic in (seed, t, elevation)
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + int(t) * 7919 + int(elev_deg * 100)) % 2**63
        )
        dbz = dbz + rng.normal(0, 0.7, size=dbz.shape)

        # radial velocity: mean wind projected on the beam + cell rotation
        az_r = np.deg2rad(az)[:, None]
        cos_el = math.cos(math.radians(elev_deg))
        vr = (self.wind[0] * np.sin(az_r) + self.wind[1] * np.cos(az_r)) * cos_el
        vr = vr + rng.normal(0, 0.5, size=dbz.shape)

        rain = dbz > 15.0
        in_ml = np.abs(h - self.melting_layer_m) < 400.0

        zdr = np.where(rain, 0.04 * (dbz - 15.0), 0.1)
        zdr = zdr + np.where(in_ml, 0.8, 0.0) + rng.normal(0, 0.12, dbz.shape)

        rhohv = np.where(rain, 0.985, 0.96) - np.where(in_ml, 0.06, 0.0)
        rhohv = np.clip(rhohv + rng.normal(0, 0.004, dbz.shape), 0.3, 1.0)

        # KDP from rain intensity; PHIDP = 2 * cumulative integral of KDP
        kdp = np.where(rain, 1.4e-2 * np.power(10.0, (dbz - 30.0) / 18.0), 0.0)
        kdp = np.clip(kdp + rng.normal(0, 0.01, dbz.shape), -0.5, 8.0)
        phidp = 2.0 * np.cumsum(kdp, axis=1) * (gate_m / 1000.0)

        wradh = np.clip(1.5 + 0.05 * (dbz - 10.0), 0.2, 8.0)
        wradh = wradh + rng.normal(0, 0.15, dbz.shape)

        out = {
            "DBZH": dbz,
            "VRADH": vr,
            "ZDR": zdr,
            "RHOHV": rhohv,
            "PHIDP": phidp,
            "KDP": kdp,
            "WRADH": wradh,
        }
        return {k: v.astype(np.float32) for k, v in out.items()}

    def volume(
        self, site: fm301.RadarSite, vcp: fm301.VCPDef, t: float
    ) -> Dict:
        """One full FM-301 volume (all sweeps) at scan time ``t``."""
        sweeps = []
        for elev in vcp.elevations:
            az = (np.arange(vcp.n_azimuth, dtype=np.float32) + 0.5) * (
                360.0 / vcp.n_azimuth
            )
            rng_m = (np.arange(vcp.n_gates, dtype=np.float32) + 0.5) * vcp.gate_m
            sweeps.append(
                {
                    "elevation": float(elev),
                    "azimuth": az,
                    "range": rng_m,
                    "moments": self.moments(
                        t, elev, vcp.n_azimuth, vcp.n_gates, vcp.gate_m
                    ),
                }
            )
        return {"site": site, "vcp": vcp, "time": float(t), "sweeps": sweeps}


# ---------------------------------------------------------------------------
# Live scan feed (streaming ingest, paper §5.4's live-append mode)
# ---------------------------------------------------------------------------

def live_scan_feed(
    *,
    site_id: str = "KVNX",
    vcp_name: str = "VCP-212",
    t0: float = 1305849600.0,  # 2011-05-20, the paper's KVNX case
    seed: int = 0,
    n_az: Optional[int] = None,
    n_gates: Optional[int] = None,
    n_sweeps: Optional[int] = None,
    start: int = 0,
) -> Iterator[Dict]:
    """Yield FM-301 volumes scan-by-scan, forever — the live-radar stand-in.

    Scan ``i`` (counting from ``start``) is the simulator volume at
    ``t0 + i * interval_s`` — a pure function of ``(seed, i, geometry)``,
    so two feeds with the same arguments yield byte-identical scan
    sequences and a restarted consumer resumes exactly where it stopped
    by passing ``start=<scans already ingested>``.  ``n_az`` /
    ``n_gates`` / ``n_sweeps`` shrink the geometry for tests while
    preserving the VCP's elevation structure, mirroring
    :func:`repro_torch.etl.pipeline.generate_raw_archive` (which batch-writes
    the *same* volumes this feed streams).
    """
    site = fm301.SITES[site_id]
    vcp = fm301.VCPS[vcp_name]
    if n_az or n_gates or n_sweeps:
        vcp = fm301.VCPDef(
            vcp.vcp_id,
            vcp.elevations[: n_sweeps or vcp.n_sweeps],
            n_az or vcp.n_azimuth,
            n_gates or vcp.n_gates,
            vcp.gate_m,
            vcp.interval_s,
        )
    sim = StormSimulator(seed=seed)
    i = int(start)
    while True:
        yield sim.volume(site, vcp, t0 + i * vcp.interval_s)
        i += 1
