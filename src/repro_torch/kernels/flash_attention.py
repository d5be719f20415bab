"""Hand-written CUDA kernel: online-softmax attention with grouped-query heads.

Wrapper around ``csrc/flash_attention.cu``, the Hopper counterpart of the
TPU kernel ``repro/kernels/flash_attention.py:flash_attention_pallas``.
The plain version is :func:`repro_torch.kernels.ref.flash_attention`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def flash_attention_cuda(
    q: torch.Tensor,           # (B, Hq, Sq, D) float32 or bfloat16, CUDA
    k: torch.Tensor,           # (B, Hkv, Skv, D) same dtype and device
    v: torch.Tensor,           # (B, Hkv, Skv, D) same dtype and device
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention on the card -> a fresh contiguous (B, Hq, Sq, D) of q's
    dtype.  q, k and v are read through their strides; each needs a
    contiguous last dimension."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda: {name} must be a CUDA "
                             f"tensor on {q.device}, got {x.device}")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError("flash_attention_cuda: q, k and v must all be "
                            "float32 or all bfloat16, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be 4-D, got "
                             f"{tuple(x.shape)}")
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"flash_attention_cuda: {name} needs a "
                             "contiguous last dimension")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError("flash_attention_cuda: need q (B, Hq, Sq, D) and k, "
                         f"v (B, Hkv, Skv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_cuda: {Hq} query heads do not "
                         f"group over {Hkv} kv heads")
    if Skv == 0:
        raise ValueError("flash_attention_cuda: no keys (Skv = 0)")
    if causal and Sq > Skv:
        raise ValueError(f"flash_attention_cuda: causal attention needs "
                         f"Sq <= Skv, got Sq={Sq}, Skv={Skv}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"flash_attention_cuda: B={B} or Hq={Hq} above the "
                         "grid's 65535")
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if B == 0 or Hq == 0 or Sq == 0:
        return out
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    fn = _cuda.launcher("flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, Hkv, Sq, Skv, D, strides, float(scale), int(causal),
                 _DTYPES.index(q.dtype), stream)
    _cuda.check("flash_attention", err)
    launches += 1
    return out
