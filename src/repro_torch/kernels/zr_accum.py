"""Hand-written CUDA kernel: fused Marshall–Palmer Z–R + time integration (§5.3).

Wrapper around ``csrc/zr_accum.cu``, the Hopper counterpart of the TPU
kernel ``repro/kernels/zr_accum.py:zr_accum_pallas``.  The plain version
is :func:`repro_torch.kernels.ref.zr_accum`; the kernel takes the rate as
one exponential, ``2 ** (dc * k1 - k0)``, whose float32 constants come
from :func:`repro_torch.kernels.ref.zr_exp2_constants`, and
:func:`repro_torch.kernels.ref.zr_accum_exp2` is that formula in torch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .ref import zr_exp2_constants

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p)


def zr_accum_cuda(
    dbz: torch.Tensor,        # (T, A, R) float32, CUDA, contiguous
    dt_s: torch.Tensor,       # (T,) float32 seconds, same device
    *,
    a: float = 200.0,
    b: float = 1.6,
    dbz_min: float = 5.0,
    dbz_max: float = 53.0,
) -> torch.Tensor:
    """Z–R rainfall accumulation on the card -> (A, R) float32 mm."""
    if dbz.device.type != "cuda" or dt_s.device != dbz.device:
        raise ValueError("zr_accum_cuda: dbz and dt_s must be CUDA tensors "
                         f"on one device, got {dbz.device} and {dt_s.device}")
    if dbz.dtype != torch.float32 or dt_s.dtype != torch.float32:
        raise TypeError("zr_accum_cuda: dbz and dt_s must be float32, got "
                        f"{dbz.dtype} and {dt_s.dtype}")
    if dbz.dim() != 3 or tuple(dt_s.shape) != (dbz.shape[0],):
        raise ValueError("zr_accum_cuda: need dbz (T, A, R) and dt_s (T,), "
                         f"got {tuple(dbz.shape)} and {tuple(dt_s.shape)}")
    if not (dbz.is_contiguous() and dt_s.is_contiguous()):
        raise ValueError("zr_accum_cuda: dbz and dt_s must be contiguous")
    T, A, R = dbz.shape
    out = torch.empty((A, R), dtype=torch.float32, device=dbz.device)
    if out.numel() == 0:
        return out
    fn = _cuda.launcher("zr_accum", _ARGTYPES)
    k1, k0 = zr_exp2_constants(a, b)
    with torch.cuda.device(dbz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dbz.data_ptr(), dt_s.data_ptr(), out.data_ptr(), T, A * R,
                 k1, k0, float(dbz_min), float(dbz_max), stream)
    _cuda.check("zr_accum", err)
    _cuda.add_launch(__name__)
    return out
