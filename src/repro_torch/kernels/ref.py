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

GRID_UPDATE_OPS = ("set", "add", "max")


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


def _take_columns(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[:, idx]`` with ``jnp.take``'s default (fill) semantics, which
    the reference oracles have: a negative index counts from the end once,
    and an index still outside ``[0, n)`` reads as NaN."""
    n = x.shape[1]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    if n == 0:
        return torch.full((x.shape[0], *idx.shape), float("nan"),
                          dtype=x.dtype, device=x.device)
    vals = x[:, torch.where(inside, idx, 0)]
    return torch.where(inside, vals, float("nan"))


def grid_map(
    field: torch.Tensor,            # (time, gates): flattened (az, range)
    gate_idx: torch.Tensor,         # (cells, k) integer flat gate indices
    weights: torch.Tensor,          # (cells, k) float32, <= 0 means "no gate"
) -> torch.Tensor:
    """Masked weighted gather: polar gates -> Cartesian cells, (time, cells).

    Each output cell is the weight-normalized mean of its (at most) k
    contributing gates, skipping non-finite gate values and non-positive
    weights; a cell with no valid contribution is NaN.  The sums are a
    left fold over j = 0 .. k-1 from +0.0, each product and each sum
    rounded on its own: the order (and the rounding) the CUDA kernel uses,
    and bitwise what the reference oracle gives.
    """
    f = field.to(torch.float32)
    w = weights.to(torch.float32)
    T, C, k = f.shape[0], gate_idx.shape[0], gate_idx.shape[1]
    vals = _take_columns(f, gate_idx.reshape(-1)).reshape(T, C, k)
    valid = torch.isfinite(vals) & (w > 0.0)[None, :, :]
    wv = torch.where(valid, w[None, :, :], 0.0)
    x = torch.where(valid, vals, 0.0)
    num = torch.zeros((T, C), dtype=torch.float32, device=f.device)
    den = torch.zeros((T, C), dtype=torch.float32, device=f.device)
    for j in range(k):
        num = num + x[:, :, j] * wv[:, :, j]
        den = den + wv[:, :, j]
    return torch.where(den > 0.0, num / torch.clamp(den, min=1e-12),
                       float("nan"))


def grid_update(
    state: torch.Tensor,            # (time, cells) current product state
    upd: torch.Tensor,              # (time, touched) freshly computed values
    pos: torch.Tensor,              # (cells,) integer: column of upd, < 0 = keep
    *,
    op: str = "set",
) -> torch.Tensor:
    """Patch only the touched cells of a gridded product, (time, cells).

    ``pos`` maps every cell to its column in the compact update block
    (negative for cells that keep their state bitwise).  ``op`` combines a
    touched cell with its update: ``"set"`` replaces, ``"add"``
    accumulates, ``"max"`` is the NaN-aware maximum (``torch.fmax``).  A
    column ``pos >= M`` reads as NaN, as in the reference oracle.  With
    ``upd`` empty along cells the state is returned unchanged.
    """
    if op not in GRID_UPDATE_OPS:
        raise ValueError(f"unknown grid_update op {op!r} (set|add|max)")
    s = state.to(torch.float32)
    if upd.shape[1] == 0 or s.shape[0] == 0 or s.shape[1] == 0:
        return s
    u = upd.to(torch.float32)
    p = pos.to(torch.int64)
    touched = p >= 0
    vals = _take_columns(u, torch.where(touched, p, 0))
    if op == "set":
        new = vals
    elif op == "add":
        new = s + vals
    else:
        new = torch.fmax(s, vals)
    return torch.where(touched[None, :], new, s)


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
