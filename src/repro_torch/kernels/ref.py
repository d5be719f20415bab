"""Plain PyTorch versions of the hand-written kernels.

These follow the reference package's oracles (``repro/kernels/ref.py``)
line by line and are the semantics of record for the CUDA kernels: on the
card ``chip_smoke.py`` holds each kernel against its plain version, and on
the CPU they are the execution path (``ops`` dispatches here for CPU
tensors).  Both take and return tensors on any device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def qvp_reduce(
    field: torch.Tensor,                   # (time, azimuth, range)
    quality: Optional[torch.Tensor] = None,  # same shape, e.g. RHOHV
    *,
    quality_min: float = 0.85,
    min_valid_fraction: float = 0.1,
) -> torch.Tensor:
    """Azimuthal mean with NaN + quality masking -> (time, range).

    A gate contributes when it is finite and its quality metric passes
    ``quality_min``.  Rows (time, range) with fewer than
    ``min_valid_fraction`` valid azimuths are NaN (Ryzhkov et al. 2016).
    """
    valid = torch.isfinite(field)
    if quality is not None:
        valid &= torch.isfinite(quality) & (quality >= quality_min)
    x = torch.where(valid, field, 0.0).to(torch.float32)
    count = valid.sum(dim=1).to(torch.float32)
    total = x.sum(dim=1)
    n_az = field.shape[1]
    mean = total / torch.clamp(count, min=1.0)
    # the threshold is compared as a float32, as the reference's weakly
    # typed Python scalar is
    threshold = float(np.float32(min_valid_fraction * n_az))
    return torch.where(count >= threshold, mean, float("nan"))


def zr_accum(
    dbz: torch.Tensor,              # (time, azimuth, range)
    dt_s: torch.Tensor,             # (time,) integration weight per scan, s
    *,
    a: float = 200.0,
    b: float = 1.6,
    dbz_min: float = 5.0,
    dbz_max: float = 53.0,          # hail cap, standard practice
) -> torch.Tensor:
    """Accumulated precipitation in mm -> (azimuth, range).

    R = (10^(dBZ/10) / a)^(1/b)  [mm/h];  accum = sum_t R_t * dt_t / 3600.
    """
    dbz_c = torch.clamp(dbz, dbz_min, dbz_max)
    z_lin = torch.pow(10.0, dbz_c / 10.0)
    rate = torch.pow(z_lin / a, 1.0 / b)                    # mm/h
    rate = torch.where(torch.isfinite(dbz) & (dbz >= dbz_min), rate, 0.0)
    w = (dt_s / 3600.0).to(torch.float32)[:, None, None]
    return torch.sum(rate * w, dim=0).to(torch.float32)
