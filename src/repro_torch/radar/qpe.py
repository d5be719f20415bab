"""Quantitative Precipitation Estimation (paper §5.3).

Marshall–Palmer Z–R over the lowest sweep, time-integrated to accumulated
precipitation.  The DataTree path reads only DBZH for the requested time
window, copies it to the device and runs the fused Z–R + integration
kernel (``zr_accum`` in CUDA on the GPU); the file-based baseline decodes
complete volumes scan-by-scan.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import ops
from ..store import Session
from ._selection import TimeSliceLike, as_time_slice


@dataclass
class QPEResult:
    """Accumulated rainfall map plus its polar axes."""
    accum_mm: np.ndarray         # (azimuth, range)
    total_hours: float
    n_scans: int
    azimuth: np.ndarray
    range_m: np.ndarray


@dataclass
class QPEInputs:
    """What a QPE reads from the store, before any device work."""
    times: np.ndarray
    dbz: np.ndarray              # (time, azimuth, range)
    azimuth: np.ndarray
    range_m: np.ndarray


def _dt_weights(times: np.ndarray) -> np.ndarray:
    """Integration weight per scan: midpoint rule over scan intervals."""
    t = np.asarray(times, dtype=np.float64)
    if t.size == 1:
        return np.array([300.0], dtype=np.float32)
    dt = np.empty_like(t)
    dt[1:-1] = (t[2:] - t[:-2]) / 2.0
    dt[0] = t[1] - t[0]
    dt[-1] = t[-1] - t[-2]
    return dt.astype(np.float32)


def read_qpe_inputs(
    session: Session,
    *,
    vcp: str,
    sweep: int = 0,
    moment: str = "DBZH",
    time_slice: TimeSliceLike = None,
) -> QPEInputs:
    """The store half of a QPE: the time axis and the moment's chunks under
    ``time_slice`` (a slice or an ``(i0, i1)`` index pair), plus the polar
    axes."""
    time_slice = as_time_slice(time_slice)
    base = f"{vcp}/sweep_{sweep}"
    return QPEInputs(
        times=session.array(f"{vcp}/time")[time_slice],
        dbz=session.array(f"{base}/{moment}")[time_slice],
        azimuth=session.array(f"{base}/azimuth").read(),
        range_m=session.array(f"{base}/range").read(),
    )


def _qpe_from_session(
    session: Session,
    *,
    vcp: str,
    sweep: int = 0,
    moment: str = "DBZH",
    time_slice: TimeSliceLike = None,
    a: float = 200.0,
    b: float = 1.6,
    mode: str = "auto",
    device: torch.device,
) -> QPEResult:
    # the QPE implementation (dispatched via repro_torch.radar.products)
    inputs = read_qpe_inputs(session, vcp=vcp, sweep=sweep, moment=moment,
                             time_slice=time_slice)
    dt_s = _dt_weights(inputs.times)
    accum = ops.zr_accum(torch.from_numpy(inputs.dbz).to(device),
                         torch.from_numpy(dt_s).to(device),
                         a=a, b=b, mode=mode).cpu().numpy()
    return QPEResult(
        accum_mm=accum,
        total_hours=float(dt_s.sum() / 3600.0),
        n_scans=len(inputs.times),
        azimuth=inputs.azimuth,
        range_m=inputs.range_m,
    )


def qpe_from_volumes(
    volumes,
    *,
    sweep: int = 0,
    moment: str = "DBZH",
    a: float = 200.0,
    b: float = 1.6,
) -> QPEResult:
    """File-based baseline: per-scan numpy Z–R then accumulate."""
    times = np.asarray([v["time"] for v in volumes])
    dt_s = _dt_weights(times)
    accum = None
    for vol, dt in zip(volumes, dt_s):
        sw = vol["sweeps"][sweep]
        dbz = sw["moments"][moment]
        dbz_c = np.clip(dbz, 5.0, 53.0)
        z_lin = np.power(10.0, dbz_c / 10.0)
        rate = np.power(z_lin / a, 1.0 / b)
        rate = np.where(np.isfinite(dbz) & (dbz >= 5.0), rate, 0.0)
        term = rate * (dt / 3600.0)
        accum = term if accum is None else accum + term
    sw0 = volumes[0]["sweeps"][sweep]
    return QPEResult(
        accum_mm=accum.astype(np.float32),
        total_hours=float(dt_s.sum() / 3600.0),
        n_scans=len(volumes),
        azimuth=sw0["azimuth"],
        range_m=sw0["range"],
    )
