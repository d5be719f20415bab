"""Fixed-location time-series extraction (paper §5.2).

Pulls a single (azimuth, range) gate neighbourhood across the whole time
axis.  Against the chunked store this touches only the chunks containing
that gate — the memory/latency win the paper reports (>10×) — whereas the
file-based baseline decodes every volume in full.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..store import Session
from ._selection import TimeSliceLike, as_time_slice


@dataclass
class PointSeries:
    """A single-gate time series plus the gate indices it tracks."""
    values: np.ndarray           # (time,)
    times: np.ndarray            # (time,)
    az_idx: int
    rng_idx: int
    moment: str


def _nearest_gate(az_deg: float, range_m: float, azimuth: np.ndarray,
                  rng: np.ndarray) -> Tuple[int, int]:
    az_idx = int(np.argmin(np.abs(((azimuth - az_deg) + 180) % 360 - 180)))
    rng_idx = int(np.argmin(np.abs(rng - range_m)))
    return az_idx, rng_idx


def _az_window_runs(center: int, halfwidth: int, n: int
                    ) -> List[Tuple[int, int]]:
    """Contiguous index runs covering the azimuth window, wrapped.

    The azimuth axis is circular — the gate-distance metric in
    :func:`_nearest_gate` already wraps — so a neighbourhood straddling
    the 0/N seam must wrap too, not clamp.  Returns 1 run when the window
    is interior (or covers the whole circle), 2 when it straddles the
    seam; runs are expressed as half-open ``[start, stop)`` row ranges so
    both the chunked store (slice reads) and in-memory baselines consume
    them identically.
    """
    width = 2 * halfwidth + 1
    if width >= n:
        return [(0, n)]
    lo = (center - halfwidth) % n
    if lo + width <= n:
        return [(lo, lo + width)]
    return [(lo, n), (0, lo + width - n)]


def iter_time_blocks(
    session: Session,
    paths: List[str],
    *,
    n_time: int,
    block: int,
    start: int = 0,
):
    """Readahead iterator over leading-axis (time) windows.

    Yields ``(i0, i1)`` half-open index windows of at most ``block`` rows
    covering ``[start, n_time)``.  Window 0 is prefetched synchronously
    (one coalesced round trip for all ``paths``); before each window is
    yielded, the *next* window's chunks are prefetched asynchronously, so
    a consumer reading ``session.array(p)[i0:i1]`` inside the loop
    overlaps its compute with the following window's fetches — the
    streaming pattern mosaic/animation products use over remote stores.
    """
    if block <= 0:
        raise ValueError("block must be positive")
    windows = [(i, min(i + block, n_time))
               for i in range(start, n_time, block)]
    if windows:
        session.prefetch(
            [(p, (slice(*windows[0]),)) for p in paths])
    for k, (i0, i1) in enumerate(windows):
        if k + 1 < len(windows):
            nxt = slice(*windows[k + 1])
            session.prefetch([(p, (nxt,)) for p in paths], wait=False)
        yield i0, i1


def point_series_from_session(
    session: Session,
    *,
    vcp: str,
    sweep: int = 0,
    moment: str = "DBZH",
    az_deg: float = 0.0,
    range_m: float = 50_000.0,
    halfwidth: int = 1,
    time_slice: TimeSliceLike = None,
) -> PointSeries:
    """Median of a (2h+1)² gate neighbourhood per scan, all scans.

    ``time_slice`` (a slice or a planner-produced ``(i0, i1)`` pair)
    restricts the series to a time window — still chunk-granular.
    """
    tsl = as_time_slice(time_slice)
    base = f"{vcp}/sweep_{sweep}"
    # geometry first (one batched round trip — the gate choice needs it),
    # then the gate windows + time axis prefetch while we compute
    session.prefetch([f"{base}/azimuth", f"{base}/range"])
    azimuth = session.array(f"{base}/azimuth").read()
    rng = session.array(f"{base}/range").read()
    ai, ri = _nearest_gate(az_deg, range_m, azimuth, rng)
    r0, r1 = max(0, ri - halfwidth), min(len(rng), ri + halfwidth + 1)
    runs = _az_window_runs(ai, halfwidth, len(azimuth))
    arr = session.array(f"{base}/{moment}")
    session.prefetch(
        [(f"{vcp}/time", (tsl,))]
        + [(f"{base}/{moment}", (tsl, slice(a0, a1), slice(r0, r1)))
           for a0, a1 in runs],
        wait=False)
    parts = [arr[tsl, a0:a1, r0:r1] for a0, a1 in runs]
    block = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
    values = np.nanmedian(block.reshape(block.shape[0], -1), axis=1)
    times = session.array(f"{vcp}/time")[tsl]
    return PointSeries(values.astype(np.float32), np.asarray(times), ai, ri,
                       moment)


def point_series_from_volumes(
    volumes,
    *,
    sweep: int = 0,
    moment: str = "DBZH",
    az_deg: float = 0.0,
    range_m: float = 50_000.0,
    halfwidth: int = 1,
) -> PointSeries:
    """File-based baseline: full decode per scan, then pick one gate."""
    values, times = [], []
    ai = ri = 0
    for vol in volumes:
        sw = vol["sweeps"][sweep]
        ai, ri = _nearest_gate(az_deg, range_m, sw["azimuth"], sw["range"])
        r0, r1 = max(0, ri - halfwidth), ri + halfwidth + 1
        m = sw["moments"][moment]
        block = np.concatenate(
            [m[a0:a1, r0:r1]
             for a0, a1 in _az_window_runs(ai, halfwidth, len(sw["azimuth"]))],
            axis=0,
        )
        values.append(np.nanmedian(block))
        times.append(vol["time"])
    return PointSeries(np.asarray(values, np.float32), np.asarray(times),
                       ai, ri, moment)
