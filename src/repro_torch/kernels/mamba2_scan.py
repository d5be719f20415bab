"""Hand-written CUDA kernel: the chunked SSD scan of the Mamba-2 mixer.

Wrapper around ``csrc/mamba2_scan.cu``, the Hopper counterpart of the TPU
kernel ``repro/kernels/mamba2_scan.py:mamba2_scan_pallas``.  Unlike the
TPU kernel it starts from an optional state ``h0``, so a serving step with
a state goes through it too.  The plain version is
:func:`repro_torch.kernels.ref.mamba2_scan`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _cuda

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

#: dynamic shared memory a block may use on Hopper (bytes)
SMEM_LIMIT = 232448
_CHUNK = 64
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (
    ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_void_p)


def smem_bytes(P: int, N: int) -> int:
    """Shared memory one block needs for state width (P, N), as
    ``csrc/mamba2_scan.cu``'s ``smem_floats`` counts it."""
    return 4 * (_CHUNK * P + 2 * _CHUNK * (N + 1) + P * (N + 1)
                + _CHUNK * (_CHUNK + 1) + 3 * _CHUNK)


def mamba2_scan_cuda(
    x: torch.Tensor,           # (B, L, H, P) float32 or bfloat16, CUDA
    dt: torch.Tensor,          # (B, L, H) float32
    A: torch.Tensor,           # (H,) float32
    Bmat: torch.Tensor,        # (B, L, N) x's dtype
    Cmat: torch.Tensor,        # (B, L, N) x's dtype
    *,
    h0: Optional[torch.Tensor] = None,   # (B, H, P, N) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan on the card -> (fresh contiguous y (B, L, H, P) of x's
    dtype, fresh final state (B, H, P, N) float32).  x, dt, Bmat and Cmat
    are read through their strides (x, Bmat and Cmat need a contiguous
    last dimension); A and h0 are read contiguous."""
    global launches
    dev = x.device
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bmat", Bmat),
                    ("Cmat", Cmat), ("h0", h0)):
        if t is not None and (t.device != dev or dev.type != "cuda"):
            raise ValueError(f"mamba2_scan_cuda: {name} must be a CUDA "
                             f"tensor on {dev}, got {t.device}")
    if x.dtype not in _DTYPES or Bmat.dtype != x.dtype \
            or Cmat.dtype != x.dtype:
        raise TypeError("mamba2_scan_cuda: x, Bmat and Cmat must all be "
                        "float32 or all bfloat16, got "
                        f"{x.dtype}, {Bmat.dtype}, {Cmat.dtype}")
    for name, t in (("dt", dt), ("A", A), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"mamba2_scan_cuda: {name} must be float32, got "
                            f"{t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"mamba2_scan_cuda: x must be (B, L, H, P), got "
                         f"{tuple(x.shape)}")
    Bsz, L, H, P = x.shape
    N = Bmat.shape[-1]
    want = {"dt": (Bsz, L, H), "A": (H,), "Bmat": (Bsz, L, N),
            "Cmat": (Bsz, L, N), "h0": (Bsz, H, P, N)}
    for name, t in (("dt", dt), ("A", A), ("Bmat", Bmat), ("Cmat", Cmat),
                    ("h0", h0)):
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"mamba2_scan_cuda: {name} must be "
                             f"{want[name]}, got {tuple(t.shape)}")
    for name, t in (("x", x), ("Bmat", Bmat), ("Cmat", Cmat)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"mamba2_scan_cuda: {name} needs a contiguous "
                             "last dimension")
    if smem_bytes(P, N) > SMEM_LIMIT:
        raise ValueError(f"mamba2_scan_cuda: state width P={P}, N={N} needs "
                         f"{smem_bytes(P, N)} bytes of shared memory, above "
                         f"the block's {SMEM_LIMIT}")
    if Bsz > 65535:
        raise ValueError(f"mamba2_scan_cuda: B={Bsz} above the grid's 65535")
    if h0 is not None:
        h0 = h0.contiguous()
    y = torch.empty((Bsz, L, H, P), dtype=x.dtype, device=dev)
    if Bsz == 0 or L == 0 or H == 0 or P == 0 or N == 0:
        # nothing to scan: the state is where it started
        h = (h0.clone() if h0 is not None
             else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                              device=dev))
        return y, h
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    A = A.contiguous()
    strides = (ctypes.c_int64 * 10)(*x.stride()[:3], *dt.stride(),
                                    *Bmat.stride()[:2], *Cmat.stride()[:2])
    fn = _cuda.launcher("mamba2_scan", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                 Cmat.data_ptr(), None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), h.data_ptr(), Bsz, L, H, P, N, strides,
                 _DTYPES.index(x.dtype), stream)
    _cuda.check("mamba2_scan", err)
    launches += 1
    return y, h
