"""Hand-written CUDA kernel: patch the touched cells of a gridded state.

Wrapper around ``csrc/grid_update.cu``, the Hopper counterpart of the TPU
kernel ``repro/kernels/grid_update.py:grid_update_pallas``, redesigned as
an in-place scatter: the caller's state is patched at an ascending cell
list, and only the touched cells are read and written.  The plain version
is :func:`repro_torch.kernels.ref.grid_scatter_`; it is bitwise
:func:`repro_torch.kernels.ref.grid_update` (the reference's pos-mapped
function) with ``pos[cells[j]] = j``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .ref import GRID_UPDATE_OPS

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_void_p)


def grid_scatter_cuda(
    state: torch.Tensor,      # (T, C) float32, CUDA, contiguous: patched
    upd: torch.Tensor,        # (T, M) float32, same device, contiguous
    cells: torch.Tensor,      # (M,) int32, same device, strictly increasing
    *,
    op: str = "set",
) -> torch.Tensor:
    """Patch ``state`` in place on the card, ``state[t, cells[j]] =
    state[t, cells[j]] (op) upd[t, j]``, and return it.

    ``cells`` must be strictly increasing and in ``[0, C)``: each cell is
    written by one thread, so a repeated cell would race.  The wrapper
    does not check it (that would wait for the card at every call); the
    port's callers make their lists with ``np.flatnonzero``, and
    :func:`repro_torch.kernels.ref.grid_scatter_` raises on a violation.
    The kernel skips a cell outside ``[0, C)`` rather than write out of
    bounds.
    """
    if op not in GRID_UPDATE_OPS:
        raise ValueError(f"unknown grid_update op {op!r} (set|add|max)")
    for name, x in (("state", state), ("upd", upd), ("cells", cells)):
        if x.device != state.device or x.device.type != "cuda":
            raise ValueError(f"grid_scatter_cuda: {name} must be a CUDA "
                             f"tensor on {state.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"grid_scatter_cuda: {name} must be contiguous")
    if state.dtype != torch.float32 or upd.dtype != torch.float32 \
            or cells.dtype != torch.int32:
        raise TypeError("grid_scatter_cuda: need float32 state and upd and "
                        f"int32 cells, got {state.dtype}, {upd.dtype}, "
                        f"{cells.dtype}")
    if state.dim() != 2 or upd.dim() != 2 or cells.dim() != 1 \
            or upd.shape[0] != state.shape[0] \
            or upd.shape[1] != cells.shape[0]:
        raise ValueError("grid_scatter_cuda: need state (T, C), upd (T, M) "
                         f"and cells (M,), got {tuple(state.shape)}, "
                         f"{tuple(upd.shape)}, {tuple(cells.shape)}")
    T, C = state.shape
    M = upd.shape[1]
    if T == 0 or C == 0 or M == 0:
        return state
    fn = _cuda.launcher("grid_update", _ARGTYPES, "grid_scatter_launch")
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(state.data_ptr(), upd.data_ptr(), cells.data_ptr(), T, C,
                 M, GRID_UPDATE_OPS.index(op), stream)
    _cuda.check("grid_update", err)
    _cuda.add_launch(__name__)
    return state
