"""Level-II-like binary volume format: the "raw archive" the ETL ingests.

Mirrors the structural properties that make real NEXRAD Level-II / SIGMET
archives slow to use scientifically — one standalone binary file per volume
scan, int16-packed moments, per-sweep compressed blocks, whole-file decode
to reach any single variable.  The format is the reference package's byte
for byte: a file written by either package decodes in the other.

Format (little-endian)::

    magic  b"RDT2" | u16 version | codec 8s (v3+) | site_id 4s
    f64 lat, lon, alt | u16 vcp_id | f64 scan_time | u16 n_sweeps
    per sweep:
        f32 elevation | u32 n_az | u32 n_gates | f32 gate_m | u16 n_moments
        per moment:
            name 8s | f32 scale | f32 offset | u32 nbytes
            codec(int16[n_az * n_gates])

Version 2 files (the pre-codec-registry format) carry no codec field and
are always zstd-compressed; version 3 names its codec in the header, so a
file written where ``zstandard`` is absent (stdlib ``zlib``) still decodes
anywhere.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import fm301
from ..store import codecs

MAGIC = b"RDT2"
VERSION = 3


def _pack_moment(name: str, data: np.ndarray) -> np.ndarray:
    scale, offset = fm301.MOMENT_PACKING.get(name, (0.01, 0.0))
    packed = np.round((data.astype(np.float64) - offset) / scale)
    packed = np.where(
        np.isfinite(data), np.clip(packed, -32767, 32767), fm301.MISSING_I16
    )
    return packed.astype(np.int16)


def _unpack_moment(name: str, packed: np.ndarray) -> np.ndarray:
    scale, offset = fm301.MOMENT_PACKING.get(name, (0.01, 0.0))
    # in-place ops: this runs on the ETL's decode hot path, where every
    # temporary is a GIL-held full-array pass that throttles pipelining
    out = packed.astype(np.float32)
    np.multiply(out, np.float32(scale), out=out)
    np.add(out, np.float32(offset), out=out)
    out[packed == fm301.MISSING_I16] = np.nan
    return out


def encode_volume(volume: Dict, codec: Optional[str] = None) -> bytes:
    """Serialize one decoded volume dict to the binary format.

    Defaults to the fastest available codec (zstd level 1 when the wheel
    is installed, stdlib zlib otherwise): raw-archive encoding is
    write-rate-bound, unlike the chunk store's read-optimized default.
    """
    cdc = codecs.get_codec(codec or codecs.fast_codec())
    if len(cdc.name.encode()) > 8:
        raise ValueError(
            f"codec name {cdc.name!r} exceeds the 8-byte header field"
        )
    site: fm301.RadarSite = volume["site"]
    vcp: fm301.VCPDef = volume["vcp"]
    parts: List[bytes] = [
        MAGIC,
        struct.pack("<H", VERSION),
        cdc.name.encode().ljust(8)[:8],
        site.site_id.encode().ljust(4)[:4],
        struct.pack("<ddd", site.latitude, site.longitude, site.altitude_m),
        struct.pack("<H", vcp.vcp_id),
        struct.pack("<d", volume["time"]),
        struct.pack("<H", len(volume["sweeps"])),
    ]
    for sweep in volume["sweeps"]:
        n_az = len(sweep["azimuth"])
        n_gates = len(sweep["range"])
        gate_m = float(sweep["range"][1] - sweep["range"][0]) if n_gates > 1 else 250.0
        moments = sweep["moments"]
        parts.append(
            struct.pack("<fIIfH", sweep["elevation"], n_az, n_gates, gate_m,
                        len(moments))
        )
        for name, data in moments.items():
            blob = cdc.encode(_pack_moment(name, data).tobytes())
            parts.append(name.encode().ljust(8)[:8])
            scale, offset = fm301.MOMENT_PACKING.get(name, (0.01, 0.0))
            parts.append(struct.pack("<ffI", scale, offset, len(blob)))
            parts.append(blob)
    return b"".join(parts)


def peek_header(blob: bytes) -> Tuple[str, str, float]:
    """Read ``(site_id, vcp_name, scan_time)`` from the fixed header only.

    The ETL uses this to establish the deterministic (vcp, time) append
    order *before* paying for full decompression — the cheap pre-sort that
    lets stage-2 decode run in a thread pool without reordering appends.
    """
    off = 6  # magic + version
    (version,) = struct.unpack_from("<H", blob, 4)
    if version == VERSION:
        off += 8  # codec field
    elif version != 2:
        raise ValueError(f"unsupported version {version}")
    site_id = blob[off : off + 4].decode().strip()
    off += 4 + 24  # site_id + lat/lon/alt
    (vcp_id,) = struct.unpack_from("<H", blob, off)
    (scan_time,) = struct.unpack_from("<d", blob, off + 2)
    return site_id, f"VCP-{vcp_id}", scan_time


def decode_volume(blob: bytes) -> Dict:
    """Decode a binary volume back to the FM-301-structured dict."""
    off = 0

    def take(n: int) -> bytes:
        nonlocal off
        out = blob[off : off + n]
        off += n
        return out

    if take(4) != MAGIC:
        raise ValueError("not an RDT2 volume file")
    (version,) = struct.unpack("<H", take(2))
    if version == 2:
        cdc = codecs.get_codec("zstd")  # v2 predates the codec field
    elif version == VERSION:
        cdc = codecs.get_codec(take(8).decode().strip())
    else:
        raise ValueError(f"unsupported version {version}")
    site_id = take(4).decode().strip()
    lat, lon, alt = struct.unpack("<ddd", take(24))
    (vcp_id,) = struct.unpack("<H", take(2))
    (scan_time,) = struct.unpack("<d", take(8))
    (n_sweeps,) = struct.unpack("<H", take(2))

    vcp = fm301.VCPS.get(f"VCP-{vcp_id}")
    site = fm301.SITES.get(
        site_id, fm301.RadarSite(site_id, lat, lon, alt)
    )
    sweeps = []
    for _ in range(n_sweeps):
        elev, n_az, n_gates, gate_m, n_moments = struct.unpack(
            "<fIIfH", take(18)
        )
        moments = {}
        for _m in range(n_moments):
            name = take(8).decode().strip()
            scale, offset, nbytes = struct.unpack("<ffI", take(12))
            packed = np.frombuffer(
                cdc.decode(take(nbytes)), dtype=np.int16
            ).reshape(n_az, n_gates)
            moments[name] = _unpack_moment(name, packed)
        az = (np.arange(n_az, dtype=np.float32) + 0.5) * (360.0 / n_az)
        rng_m = (np.arange(n_gates, dtype=np.float32) + 0.5) * gate_m
        sweeps.append(
            {
                "elevation": float(elev),
                "azimuth": az,
                "range": rng_m,
                "moments": moments,
            }
        )
    if vcp is None:
        elevs = tuple(s["elevation"] for s in sweeps)
        vcp = fm301.VCPDef(vcp_id, elevs, sweeps[0]["azimuth"].size,
                           sweeps[0]["range"].size, gate_m, 300.0)
    return {"site": site, "vcp": vcp, "time": scan_time, "sweeps": sweeps}
