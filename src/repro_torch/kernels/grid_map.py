"""Hand-written CUDA kernel: masked gather-regrid, polar gates -> grid cells,
with the NaN-aware max over sweeps folded in.

Wrapper around ``csrc/grid_map.cu``, the Hopper counterpart of the TPU
kernel ``repro/kernels/grid_map.py:grid_map_pallas`` (and, for
column-max, of the per-sweep launches and the ``fmax`` the reference
runs after them).  The plain version is
:func:`repro_torch.kernels.ref.grid_map`.  :func:`cell_order` is the
traversal the kernel wants (8 x 8 tiles of the grid, the cells out of
reach last), computed once per map on the host; :class:`CellOrder` holds
it on the device, checked once when it is made.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _cuda
from .ref import live_slots

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

#: the most sweeps one launch folds (csrc/grid_map.cu, kMaxSweeps)
MAX_SWEEPS = 32
#: the time rows a thread may take (csrc/grid_map.cu, launch_rows)
ROWS_CHOICES = (1, 2, 4, 8)
#: the side of the square tiles of grid cells the kernel walks one by one
TILE = 8

_ARGTYPES = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p)


def rows_per_thread(T: int, k: int) -> int:
    """Time rows a thread takes: 1 for a one-slot (nearest) map, 8 for
    wider maps (their slots' gathers overlap), never more than T; as
    measured on the card (PERF.md, the `grid_map` row)."""
    rows = 1 if k <= 1 else 8
    while rows > max(T, 1):
        rows //= 2
    return rows


def cell_order(gate_idx: np.ndarray, weights: np.ndarray, n_gates: int,
               shape: Tuple[int, int]) -> Tuple[np.ndarray, int]:
    """The kernel's traversal of a (C, k) or (C, S, k) map over a raster
    of ``shape`` = (ny, nx) cells (C = ny * nx, row-major): ``(order,
    n_live)``, ``order`` a permutation of the C cells, the ``n_live``
    cells with a live slot (``ref.live_slots``) first, ``TILE`` x
    ``TILE`` tiles of the raster one after another (row by row inside a
    tile), then the cells out of every sweep's reach in cell order."""
    idx = np.asarray(gate_idx)
    w = np.asarray(weights)
    if idx.ndim == 2:
        idx, w = idx[:, None, :], w[:, None, :]
    ny, nx = shape
    C = idx.shape[0]
    if C != ny * nx:
        raise ValueError(f"cell_order: {C} map rows for a {ny} x {nx} "
                         "raster")
    if C == 0:
        return np.arange(0), 0
    live = live_slots(torch.from_numpy(np.array(idx)),
                      torch.from_numpy(np.array(w)),
                      n_gates).reshape(C, -1).any(dim=1).numpy()
    y, x = np.divmod(np.arange(C, dtype=np.int64), nx)
    tiles_x = -(-nx // TILE)
    key = ((y // TILE) * tiles_x + x // TILE) * TILE * TILE \
        + (y % TILE) * TILE + x % TILE
    key = np.where(live, key, key.max() + 1 + np.arange(C))
    return np.argsort(key, kind="stable"), int(live.sum())


@dataclass(frozen=True)
class CellOrder:
    """Where the kernel writes each map row: row i to output column
    ``cells[i]``, the rows from ``n_live`` on promised to reach no gate
    (they are written NaN without a load).  Made with a check that
    ``cells`` is a permutation of the columns, so that no two rows write
    one column and none is left unwritten; the plain version checks the
    promise of ``n_live`` against the map."""

    cells: torch.Tensor         # (C,) int32
    n_live: int

    def __post_init__(self):
        cells, C = self.cells, self.cells.numel()
        if cells.dim() != 1 or cells.dtype != torch.int32:
            raise ValueError("CellOrder: cells must be a 1-D int32 tensor, "
                             f"got {cells.dtype} {tuple(cells.shape)}")
        if not 0 <= self.n_live <= C:
            raise ValueError(f"CellOrder: n_live {self.n_live} outside "
                             f"[0, {C}]")
        # a meta tensor holds no values to check
        if not cells.is_meta and not torch.equal(
                torch.sort(cells).values,
                torch.arange(C, dtype=torch.int32, device=cells.device)):
            raise ValueError(f"CellOrder: cells must be a permutation of the "
                             f"{C} columns")


def grid_map_cuda(
    fields: Sequence[torch.Tensor],   # S x (T, G) float32, CUDA, contiguous
    gate_idx: torch.Tensor,           # (C, S, k) int32, same device
    weights: torch.Tensor,            # (C, S, k) float32, same device
    cells: Optional[torch.Tensor] = None,   # (C,) int32: row i -> column
    n_live: Optional[int] = None,     # rows from here on write NaN
) -> torch.Tensor:
    """Masked weighted gather over S sweeps, folded by ``fmax``, on the
    card -> (T, C) float32.  ``cells`` and ``n_live`` are trusted, as a
    :class:`CellOrder` holds them: a row whose ``cells`` entry falls
    outside [0, C) writes nothing (its column is left as it was
    allocated), and a repeated entry makes its rows race."""
    if not 1 <= len(fields) <= MAX_SWEEPS:
        raise ValueError(f"grid_map_cuda: 1 to {MAX_SWEEPS} fields, got "
                         f"{len(fields)}")
    dev = fields[0].device
    named = [(f"fields[{s}]", f, 2) for s, f in enumerate(fields)]
    named += [("gate_idx", gate_idx, 3), ("weights", weights, 3)]
    if cells is not None:
        named.append(("cells", cells, 1))
    for name, x, ndim in named:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"grid_map_cuda: {name} must be a CUDA tensor "
                             f"on {dev}, got {x.device}")
        if x.dim() != ndim or not x.is_contiguous():
            raise ValueError(f"grid_map_cuda: {name} must be {ndim}-D and "
                             f"contiguous, got shape {tuple(x.shape)}")
    if any(f.dtype != torch.float32 for f in fields) \
            or weights.dtype != torch.float32 \
            or gate_idx.dtype != torch.int32 \
            or (cells is not None and cells.dtype != torch.int32):
        raise TypeError("grid_map_cuda: need float32 fields and weights and "
                        "int32 gate_idx and cells")
    T, G = fields[0].shape
    if any(tuple(f.shape) != (T, G) for f in fields):
        raise ValueError("grid_map_cuda: the fields differ in shape: "
                         f"{[tuple(f.shape) for f in fields]}")
    C, S, k = gate_idx.shape
    if tuple(weights.shape) != (C, S, k) or S != len(fields):
        raise ValueError(f"grid_map_cuda: gate_idx {tuple(gate_idx.shape)}, "
                         f"weights {tuple(weights.shape)} and {len(fields)} "
                         "fields disagree")
    if cells is not None and cells.numel() != C:
        raise ValueError(f"grid_map_cuda: cells has {cells.numel()} entries "
                         f"for {C} map rows")
    n_live = C if n_live is None else int(n_live)
    if not 0 <= n_live <= C:
        raise ValueError(f"grid_map_cuda: n_live {n_live} outside [0, {C}]")
    rows = rows_per_thread(T, k)
    if T == 0 or C == 0:
        # an empty planner window or an empty grid: nothing to launch
        return torch.full((T, C), float("nan"), dtype=torch.float32,
                          device=dev)
    out = torch.empty((T, C), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * S)(*[f.data_ptr() for f in fields])
    fn = _cuda.launcher("grid_map", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ctypes.cast(ptrs, ctypes.c_void_p), S, gate_idx.data_ptr(),
                 weights.data_ptr(),
                 None if cells is None else cells.data_ptr(), n_live,
                 out.data_ptr(), T, G, C, k, rows, stream)
    _cuda.check("grid_map", err)
    _cuda.add_launch(__name__)
    return out
