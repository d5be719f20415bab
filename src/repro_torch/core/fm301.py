"""WMO FM-301 / CfRadial 2.1 schema: moments, CF metadata, VCP definitions.

FM-301 (WMO-No. 306, Manual on Codes) standardizes *single* radar volumes:
a root group with instrument metadata plus one ``sweep_NNNN`` group per
elevation cut, each holding CF-compliant polar-coordinate variables.  This
module encodes that schema; :mod:`repro_torch.core.datatree` extends it from one
volume to a time-resolved archive (the paper's contribution).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

CONVENTIONS = "Cf/Radial-2.1 FM-301"

# ---------------------------------------------------------------------------
# Polarimetric moments with CF attributes (CfRadial 2.1 standard names)
# ---------------------------------------------------------------------------

MOMENTS: Dict[str, Dict[str, str]] = {
    "DBZH": {
        "standard_name": "equivalent_reflectivity_factor",
        "long_name": "Equivalent reflectivity factor H",
        "units": "dBZ",
    },
    "VRADH": {
        "standard_name": "radial_velocity_of_scatterers_away_from_instrument",
        "long_name": "Radial velocity of scatterers away from instrument H",
        "units": "m/s",
    },
    "ZDR": {
        "standard_name": "log_differential_reflectivity_hv",
        "long_name": "Log differential reflectivity H/V",
        "units": "dB",
    },
    "RHOHV": {
        "standard_name": "cross_correlation_ratio_hv",
        "long_name": "Cross correlation ratio HV",
        "units": "unitless",
    },
    "PHIDP": {
        "standard_name": "differential_phase_hv",
        "long_name": "Differential phase HV",
        "units": "degrees",
    },
    "KDP": {
        "standard_name": "specific_differential_phase_hv",
        "long_name": "Specific differential phase HV",
        "units": "degrees/km",
    },
    "WRADH": {
        "standard_name": "radial_velocity_spectrum_width",
        "long_name": "Doppler spectrum width H",
        "units": "m/s",
    },
}

# int16 packing used by the Level-II-like encoding (scale, offset) per moment
MOMENT_PACKING: Dict[str, Tuple[float, float]] = {
    "DBZH": (0.01, 0.0),      # -327 .. 327 dBZ at 0.01 resolution
    "VRADH": (0.01, 0.0),
    "ZDR": (0.005, 0.0),
    "RHOHV": (0.0001, 0.5),   # 0.5 offset centres the 0..1.05 range
    "PHIDP": (0.02, 180.0),
    "KDP": (0.005, 0.0),
    "WRADH": (0.01, 0.0),
}

MISSING_I16 = -32768  # sentinel for missing gates in packed data


# ---------------------------------------------------------------------------
# Volume Coverage Patterns (NEXRAD operational definitions, abridged)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VCPDef:
    """Sweep strategy: which elevation cuts a volume contains."""

    vcp_id: int
    elevations: Tuple[float, ...]       # fixed angles, degrees
    n_azimuth: int                      # radials per sweep
    n_gates: int                        # range gates per radial
    gate_m: float                       # gate spacing, metres
    interval_s: float                   # nominal volume repeat period
    moments: Tuple[str, ...] = tuple(MOMENTS)

    @property
    def name(self) -> str:
        return f"VCP-{self.vcp_id}"

    @property
    def n_sweeps(self) -> int:
        return len(self.elevations)


VCPS: Dict[str, VCPDef] = {
    v.name: v
    for v in [
        # storm-mode, 14 cuts (NEXRAD VCP 12 family)
        VCPDef(12, (0.5, 0.9, 1.3, 1.8, 2.4, 3.1, 4.0, 5.1, 6.4, 8.0,
                    10.0, 12.5, 15.6, 19.5), 720, 1192, 250.0, 270.0),
        VCPDef(212, (0.5, 0.9, 1.3, 1.8, 2.4, 3.1, 4.0, 5.1, 6.4, 8.0,
                     10.0, 12.5, 15.6, 19.5), 720, 1192, 250.0, 270.0),
        # precipitation-mode, 9 cuts
        VCPDef(21, (0.5, 1.45, 2.4, 3.35, 4.3, 6.0, 9.9, 14.6, 19.5),
               360, 996, 250.0, 360.0),
        VCPDef(215, (0.5, 0.9, 1.3, 1.8, 2.4, 3.1, 4.0, 5.1, 6.4, 8.0,
                     10.0, 12.0, 14.0, 16.7, 19.5), 720, 1192, 250.0, 330.0),
        # clear-air mode, 5 cuts
        VCPDef(31, (0.5, 1.5, 2.5, 3.5, 4.5), 360, 996, 250.0, 600.0),
    ]
}


@dataclass(frozen=True)
class RadarSite:
    """A radar site's identity and geographic location."""
    site_id: str
    latitude: float
    longitude: float
    altitude_m: float
    instrument_name: str = ""

    def root_attrs(self) -> Dict[str, object]:
        return {
            "Conventions": CONVENTIONS,
            "instrument_name": self.instrument_name or self.site_id,
            "site_id": self.site_id,
            "latitude": self.latitude,
            "longitude": self.longitude,
            "altitude": self.altitude_m,
            "platform_type": "fixed",
            "instrument_type": "radar",
        }


SITES: Dict[str, RadarSite] = {
    "KVNX": RadarSite("KVNX", 36.7406, -98.1279, 369.0, "WSR-88D KVNX"),
    "KTLX": RadarSite("KTLX", 35.3331, -97.2778, 370.0, "WSR-88D KTLX"),
    "KICT": RadarSite("KICT", 37.6546, -97.4428, 407.0, "WSR-88D KICT"),
}


def sweep_group_name(i: int) -> str:
    """Canonical FM301 group name for sweep index ``i``."""
    return f"sweep_{i}"


def sweep_attrs(vcp: VCPDef, sweep_idx: int) -> Dict[str, object]:
    """FM301 attribute document for one sweep of ``vcp``."""
    return {
        "sweep_number": sweep_idx,
        "fixed_angle": vcp.elevations[sweep_idx],
        "sweep_mode": "azimuth_surveillance",
        "prt_mode": "fixed",
    }
