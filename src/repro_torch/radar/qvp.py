"""Quasi-Vertical Profiles from a Radar DataTree (paper §5.1).

A QVP (Ryzhkov et al. 2016) composites azimuthal means of a high-elevation
sweep over time, giving a time–height view of storm microphysics.  Against
the DataTree store this is: one chunk-aligned lazy read of exactly the
(sweep, moment[, quality]) arrays requested, one copy to the device, then
one fused reduction (the ``qvp_reduce`` CUDA kernel on the GPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels import ops
from ..store import Session
from . import geometry
from ._selection import TimeSliceLike, as_time_slice


@dataclass
class QVPResult:
    """A quasi-vertical profile: (time, height) matrix plus axes."""
    profile: np.ndarray          # (time, range) azimuthal means
    times: np.ndarray            # (time,) epoch seconds
    height_m: np.ndarray         # (range,) beam height AGL
    moment: str
    elevation_deg: float

    @property
    def shape(self):
        return self.profile.shape


@dataclass
class QVPInputs:
    """What a QVP reads from the store, before any device work."""
    times: np.ndarray
    field: np.ndarray             # (time, azimuth, range)
    quality: Optional[np.ndarray]
    range_m: np.ndarray
    elevation_deg: float


def read_qvp_inputs(
    session: Session,
    *,
    vcp: str,
    sweep: int,
    moment: str = "DBZH",
    quality_moment: Optional[str] = "RHOHV",
    time_slice: TimeSliceLike = None,
) -> QVPInputs:
    """The store half of a QVP: one prefetch plan, then chunk-aligned reads
    of exactly the arrays the profile needs.  ``time_slice`` accepts a
    slice or an ``(i0, i1)`` index pair."""
    time_slice = as_time_slice(time_slice)
    base = f"{vcp}/sweep_{sweep}"
    # every array the profile needs, one asynchronous prefetch plan:
    # time + field + quality + range stream in batched while the first
    # demand read below waits only on its own chunks
    items = [(f"{vcp}/time", (time_slice,)),
             (f"{base}/{moment}", (time_slice,)),
             f"{base}/range"]
    if quality_moment is not None:
        items.append((f"{base}/{quality_moment}", (time_slice,)))
    session.prefetch(items, wait=False)
    times = session.array(f"{vcp}/time")[time_slice]
    field = session.array(f"{base}/{moment}")[time_slice]
    quality = None
    if quality_moment is not None and session.has_array(
        f"{base}/{quality_moment}"
    ):
        quality = session.array(f"{base}/{quality_moment}")[time_slice]
    return QVPInputs(
        times=np.asarray(times),
        field=field,
        quality=quality,
        range_m=session.array(f"{base}/range").read(),
        elevation_deg=float(session.group_attrs(base)["fixed_angle"]),
    )


def _qvp_from_session(
    session: Session,
    *,
    vcp: str,
    sweep: int,
    moment: str = "DBZH",
    quality_moment: Optional[str] = "RHOHV",
    quality_min: float = 0.85,
    time_slice: TimeSliceLike = None,
    mode: str = "auto",
    device: torch.device,
) -> QVPResult:
    # the QVP implementation (dispatched via repro_torch.radar.products)
    inputs = read_qvp_inputs(session, vcp=vcp, sweep=sweep, moment=moment,
                             quality_moment=quality_moment,
                             time_slice=time_slice)
    field = torch.from_numpy(inputs.field).to(device)
    quality = (None if inputs.quality is None
               else torch.from_numpy(inputs.quality).to(device))
    profile = ops.qvp_reduce(field, quality, quality_min=quality_min,
                             mode=mode).cpu().numpy()
    height = geometry.beam_height_m(inputs.range_m, inputs.elevation_deg)
    return QVPResult(profile, inputs.times, np.asarray(height), moment,
                     inputs.elevation_deg)


def qvp_from_volumes(
    volumes,
    *,
    sweep: int,
    moment: str = "DBZH",
    quality_moment: Optional[str] = "RHOHV",
    quality_min: float = 0.85,
) -> QVPResult:
    """File-based QVP baseline.

    The Py-ART-style workflow the paper compares against: each decoded
    volume is processed scan-by-scan with plain numpy."""
    profiles, times = [], []
    elev, rng_m = 0.0, None
    for vol in volumes:
        sw = vol["sweeps"][sweep]
        field = sw["moments"][moment]
        valid = np.isfinite(field)
        if quality_moment is not None and quality_moment in sw["moments"]:
            q = sw["moments"][quality_moment]
            valid &= np.isfinite(q) & (q >= quality_min)
        x = np.where(valid, field, 0.0)
        count = valid.sum(axis=0).astype(np.float32)
        mean = x.sum(axis=0) / np.maximum(count, 1.0)
        mean = np.where(count >= 0.1 * field.shape[0], mean, np.nan)
        profiles.append(mean.astype(np.float32))
        times.append(vol["time"])
        elev = sw["elevation"]
        rng_m = sw["range"]
    height = geometry.beam_height_m(rng_m, elev)
    return QVPResult(np.stack(profiles), np.asarray(times),
                     np.asarray(height), moment, elev)
