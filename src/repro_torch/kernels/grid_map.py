"""Hand-written CUDA kernel: masked gather-regrid, polar gates -> grid cells.

Wrapper around ``csrc/grid_map.cu``, the Hopper counterpart of the TPU
kernel ``repro/kernels/grid_map.py:grid_map_pallas``.  The plain version
is :func:`repro_torch.kernels.ref.grid_map`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p)


def grid_map_cuda(
    field: torch.Tensor,      # (T, G) float32, CUDA, contiguous
    gate_idx: torch.Tensor,   # (C, k) int32, same device, contiguous
    weights: torch.Tensor,    # (C, k) float32, same device, contiguous
) -> torch.Tensor:
    """Masked weighted gather on the card -> (T, C) float32."""
    global launches
    tensors = {"field": field, "gate_idx": gate_idx, "weights": weights}
    for name, x in tensors.items():
        if x.device != field.device or x.device.type != "cuda":
            raise ValueError(f"grid_map_cuda: {name} must be a CUDA tensor "
                             f"on {field.device}, got {x.device}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"grid_map_cuda: {name} must be 2-D and "
                             f"contiguous, got shape {tuple(x.shape)}")
    if field.dtype != torch.float32 or weights.dtype != torch.float32 \
            or gate_idx.dtype != torch.int32:
        raise TypeError("grid_map_cuda: need float32 field and weights and "
                        f"int32 gate_idx, got {field.dtype}, "
                        f"{weights.dtype}, {gate_idx.dtype}")
    if gate_idx.shape != weights.shape:
        raise ValueError(f"grid_map_cuda: gate_idx {tuple(gate_idx.shape)} "
                         f"and weights {tuple(weights.shape)} differ")
    T, G = field.shape
    C, k = gate_idx.shape
    if T == 0 or C == 0:
        # an empty planner window or an empty grid: nothing to launch
        return torch.full((T, C), float("nan"), dtype=torch.float32,
                          device=field.device)
    out = torch.empty((T, C), dtype=torch.float32, device=field.device)
    fn = _cuda.launcher("grid_map", _ARGTYPES)
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(field.data_ptr(), gate_idx.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), T, G, C, k, stream)
    _cuda.check("grid_map", err)
    launches += 1
    return out
