"""Hand-written CUDA kernel: masked azimuthal-mean reduction for QVPs (§5.1).

Wrapper around ``csrc/qvp_reduce.cu``, the Hopper counterpart of the TPU
kernel ``repro/kernels/qvp_reduce.py:qvp_reduce_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.qvp_reduce`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_float, ctypes.c_float, ctypes.c_void_p)


def _check_input(name: str, x: torch.Tensor, like: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"qvp_reduce_cuda: {name} must be a CUDA tensor, "
                         f"got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"qvp_reduce_cuda: {name} must be float32, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"qvp_reduce_cuda: {name} must be (T, A, R), "
                         f"got shape {tuple(x.shape)}")
    if x.shape != like.shape or x.device != like.device:
        raise ValueError("qvp_reduce_cuda: field and quality must share "
                         "shape and device")
    if not x.is_contiguous():
        raise ValueError(f"qvp_reduce_cuda: {name} must be contiguous")


def qvp_reduce_cuda(
    field: torch.Tensor,      # (T, A, R) float32, CUDA, contiguous
    quality: torch.Tensor,    # (T, A, R) float32, CUDA, contiguous
    *,
    quality_min: float = 0.85,
    min_valid_fraction: float = 0.1,
) -> torch.Tensor:
    """Quality-masked azimuthal mean on the card -> (T, R) float32."""
    global launches
    _check_input("field", field, field)
    _check_input("quality", quality, field)
    T, A, R = field.shape
    out = torch.empty((T, R), dtype=torch.float32, device=field.device)
    if out.numel() == 0:
        return out
    # float32 threshold, as the reference compares (see ref.qvp_reduce)
    min_count = float(np.float32(min_valid_fraction * A))
    fn = _cuda.launcher("qvp_reduce", _ARGTYPES)
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(field.data_ptr(), quality.data_ptr(), out.data_ptr(),
                 T, A, R, float(quality_min), min_count, stream)
    _cuda.check("qvp_reduce", err)
    launches += 1
    return out
