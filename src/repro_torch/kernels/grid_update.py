"""Hand-written CUDA kernel: patch the touched cells of a gridded state.

Wrapper around ``csrc/grid_update.cu``, the Hopper counterpart of the TPU
kernel ``repro/kernels/grid_update.py:grid_update_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.grid_update`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .ref import GRID_UPDATE_OPS

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)


def grid_update_cuda(
    state: torch.Tensor,      # (T, C) float32, CUDA, contiguous
    upd: torch.Tensor,        # (T, M) float32, same device, contiguous
    pos: torch.Tensor,        # (C,) int32, same device
    *,
    op: str = "set",
) -> torch.Tensor:
    """Patch touched cells on the card -> a fresh (T, C) float32."""
    global launches
    if op not in GRID_UPDATE_OPS:
        raise ValueError(f"unknown grid_update op {op!r} (set|add|max)")
    for name, x in (("state", state), ("upd", upd), ("pos", pos)):
        if x.device != state.device or x.device.type != "cuda":
            raise ValueError(f"grid_update_cuda: {name} must be a CUDA "
                             f"tensor on {state.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"grid_update_cuda: {name} must be contiguous")
    if state.dtype != torch.float32 or upd.dtype != torch.float32 \
            or pos.dtype != torch.int32:
        raise TypeError("grid_update_cuda: need float32 state and upd and "
                        f"int32 pos, got {state.dtype}, {upd.dtype}, "
                        f"{pos.dtype}")
    if state.dim() != 2 or upd.dim() != 2 or upd.shape[0] != state.shape[0] \
            or tuple(pos.shape) != (state.shape[1],):
        raise ValueError("grid_update_cuda: need state (T, C), upd (T, M) "
                         f"and pos (C,), got {tuple(state.shape)}, "
                         f"{tuple(upd.shape)}, {tuple(pos.shape)}")
    T, C = state.shape
    M = upd.shape[1]
    if T == 0 or C == 0 or M == 0:
        # nothing to patch (or nothing to patch into): the state is the
        # answer, as in the plain version
        return state.clone()
    out = torch.empty_like(state)
    fn = _cuda.launcher("grid_update", _ARGTYPES)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(state.data_ptr(), upd.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), T, C, M, GRID_UPDATE_OPS.index(op), stream)
    _cuda.check("grid_update", err)
    launches += 1
    return out
