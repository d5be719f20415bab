"""Hand-written CUDA kernels: online-softmax attention with grouped-query heads.

The Hopper counterpart of the TPU kernel
``repro/kernels/flash_attention.py:flash_attention_pallas``; the plain
version is :func:`repro_torch.kernels.ref.flash_attention`.  Three kernels
stand behind the one wrapper, and the route is chosen from the dtype and
Sq alone (:func:`route`):

* ``"decode"`` (Sq == 1, float32 or bfloat16): ``csrc/flash_decode.cu``,
  the keys split over a cluster of blocks, the query heads of a KV head in
  one block; its split is :func:`decode_splits`, and its plain version with
  the same splits :func:`repro_torch.kernels.ref.flash_decode`;
* ``"tc_prefill"`` (Sq > 1, bfloat16): ``csrc/flash_attention.cu``'s
  ``flash_attention_tc_launch``, wgmma on the tensor cores fed by TMA;
* ``"f32"`` (Sq > 1, float32): ``csrc/flash_attention.cu``'s
  ``flash_attention_launch``, the same tensor cores with every float32
  operand as a bf16 pair, ``hi = bf16(v)``, ``lo = bf16(v - hi)``, and
  every product as three bf16 products; its plain version with the same
  roundings is :func:`repro_torch.kernels.ref.flash_attention_pairs`.
"""

from __future__ import annotations

import array
import contextlib
import ctypes
from typing import Optional

import torch

from . import _cuda

#: wrapper calls that launched a kernel since import (or since a caller
#: reset it to 0); one per attention call, whatever the route
launches = 0
#: the same calls by route; they add up to ``launches``
route_launches = {"decode": 0, "tc_prefill": 0, "f32": 0}

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8          # query heads per KV head the decode kernel takes
MAX_SPLIT = 8          # key splits: the portable thread-block cluster
MIN_SPLIT_KEYS = 64    # keys a split holds at least
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.c_void_p    # 12 int64 element strides
# q, k, v, o, B, Hq, Hkv, then (Sq, Skv, D) for a prefill or (Skv, D,
# n_split) for decode, the strides, the scale, causal (prefill) or the
# dtype (decode), the stream
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _STRIDES,
             ctypes.c_float, _I, _P)
# route -> (library, C symbol)
_SYMBOLS = {
    "f32": ("flash_attention", "flash_attention_launch"),
    "tc_prefill": ("flash_attention", "flash_attention_tc_launch"),
    "decode": ("flash_decode", "flash_decode_launch"),
}
_fns = {}      # route -> its bound C function, once loaded
_sms = {}      # device index -> streaming multiprocessors


def route(q: torch.Tensor) -> str:
    """The kernel a call with this q goes to: ``"decode"`` for one query,
    else ``"tc_prefill"`` for bfloat16 and ``"f32"`` for float32."""
    if q.shape[2] == 1:
        return "decode"
    return "tc_prefill" if q.dtype == torch.bfloat16 else "f32"


def decode_splits(bh: int, skv: int, n_sm: int) -> int:
    """Key splits of the decode kernel for ``bh`` = B * Hkv blocks of
    ``skv`` keys on a card of ``n_sm`` SMs: the fewest that put a block on
    every SM, at most ``MAX_SPLIT``, each of ``MIN_SPLIT_KEYS`` keys or
    more (so at least 1)."""
    cover = -(-n_sm // max(bh, 1))
    return max(1, min(MAX_SPLIT, cover, skv // MIN_SPLIT_KEYS))


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib, symbol = _SYMBOLS[name]
        fn = _fns[name] = _cuda.launcher(lib, _ARGTYPES, symbol=symbol)
    return fn


def _sm_count(device: torch.device) -> int:
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _aligned(x: torch.Tensor, st) -> bool:
    """Whether ``x`` starts on 16 bytes and its batch, head and sequence
    strides ``st`` are whole 16-byte units (the vector and TMA loads)."""
    return not (x.data_ptr() | (st[0] | st[1] | st[2]) * x.element_size()) \
        & 15


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
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev):
        for name, x in (("q", q), ("k", k), ("v", v)):
            if not x.is_cuda or x.device != dev:
                raise ValueError(f"flash_attention_cuda: {name} must be a "
                                 f"CUDA tensor on {dev}, got {x.device}")
    dtype = q.dtype
    if not (dtype in _DTYPES and k.dtype == dtype and v.dtype == dtype):
        raise TypeError("flash_attention_cuda: q, k and v must all be "
                        "float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_cuda: q, k and v must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if D > 1 and (qs[3] != 1 or ks[3] != 1 or vs[3] != 1):
        raise ValueError("flash_attention_cuda: q, k and v need a "
                         "contiguous last dimension")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
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
    which = route(q)
    if which == "decode" and Hq // Hkv > MAX_GROUP:
        raise ValueError(f"flash_attention_cuda: decode takes at most "
                         f"{MAX_GROUP} query heads per kv head, got "
                         f"{Hq // Hkv}")
    out = torch.empty((B, Hq, Sq, D), dtype=dtype, device=dev)
    if B == 0 or Hq == 0 or Sq == 0:
        return out
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    # the vector and TMA loads want 16-byte units: copy what is not
    if not _aligned(q, qs):
        q = q.clone(memory_format=torch.contiguous_format)
        qs = q.stride()
    if not _aligned(k, ks):
        k = k.clone(memory_format=torch.contiguous_format)
        ks = k.stride()
    if not _aligned(v, vs):
        v = v.clone(memory_format=torch.contiguous_format)
        vs = v.stride()
    # element strides: batch, head and sequence of q, k, v and out
    strides = array.array("q", (*qs[:3], *ks[:3], *vs[:3],
                                Hq * Sq * D, Sq * D, D))
    fn = _launcher(which)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv)
    index = dev.index
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        stream = torch._C._cuda_getCurrentRawStream(index)
        if which == "decode":
            n_split = decode_splits(B * Hkv, Skv, _sm_count(dev))
            err = fn(*head, Skv, D, n_split, strides.buffer_info()[0], scale,
                     _DTYPES.index(dtype), stream)
        else:
            err = fn(*head, Sq, Skv, D, strides.buffer_info()[0], scale,
                     int(causal), stream)
    _cuda.check(f"flash_attention ({which})", err)
    launches += 1
    route_launches[which] += 1
    return out
