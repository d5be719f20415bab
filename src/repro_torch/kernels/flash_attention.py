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

Every route takes any head dim D, as the TPU kernel does.  Up to 256 a
kernel of width :func:`kernel_dim` (a multiple of 16 up to 128, then 160,
192, 224 or 256) reads the caller's D columns and fills the rest of its
width with zeros, exact because a zero column adds an exact zero to every
q.k, and stores D columns.  Above ``WIDE_PREFILL_ABOVE`` (192 in
bfloat16, 128 in float32; the wide kernel is the faster there) both
prefill routes go to ``csrc/flash_attention.cu``'s
``flash_attention_wide_launch`` (counted also in ``wide_launches``),
wgmma fed by TMA: a block of two consumer warpgroups and a producer
warpgroup computes S = QK^T once per 64-row query tile, summed over k-slices of
``WIDE_SLICE`` columns (the even slices by one warpgroup, the odd by the
other, the halves added through shared memory), and each warpgroup keeps
up to ``WIDE_MAX_CHUNKS`` chunks of ``WIDE_SLICE`` columns of o in its
accumulators, so one block covers all of D up to 512 and column blocks
split a wider D over the grid (:func:`wide_tiling`).  float32 goes as
bf16 pairs there too, every float32 tile split once in shared memory.  The
decode kernel walks a key row in passes of 256 columns, a block owning 256
columns of v and o.  The decode kernel holds at most ``MAX_GROUP`` query
heads of a KV head in a block; a wider group is sliced over the grid
(:func:`decode_tiling`).  A row that is not a whole number of 16-byte
units (D not a multiple of 8 in bfloat16 or of 4 in float32) is first
copied into zero-padded rows.
"""

from __future__ import annotations

import array
import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from . import _cuda

#: wrapper calls that launched a kernel since import (or since a caller
#: reset it to 0); one per attention call, whatever the route
launches = 0
#: the same calls by route; they add up to ``launches``
route_launches = {"decode": 0, "tc_prefill": 0, "f32": 0}
#: those of the prefill routes' calls that launched the wide kernel
wide_launches = {"tc_prefill": 0, "f32": 0}

#: the kernel widths of one column group, on every route: the multiples of
#: 16 up to 128 (the tensor cores' k16 step and whole 16-column sub-tiles)
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
#: the kernel widths above 128: a prefill block owns half the columns of v
#: and o (two column groups), the decode kernel's warp one key row
WIDE_HEAD_DIMS = (160, 192, 224, 256)
#: the widest head dim a kernel width serves; above it the decode kernel
#: walks a key row in passes
SLICED_ABOVE = 256
#: above this head dim a prefill goes to the wide kernel, by dtype: the
#: widths where it beat the narrow kernel at every shape measured on the
#: card (bf16 at D 224 and 256, not at 160 or 192; float32 at 160 to 256)
WIDE_PREFILL_ABOVE = {torch.bfloat16: 192, torch.float32: 128}
#: columns of D in a k-slice of the wide prefill, and of o in a chunk
WIDE_SLICE = 64
WIDE_GROUPS = 2        # consumer warpgroups of a wide prefill block
WIDE_MAX_CHUNKS = 4    # chunks of o a warpgroup keeps in its accumulators
DECODE_PASS = 256      # columns of a decode pass and of its column group
MAX_GROUP = 8          # query heads of a KV head one decode block holds
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
# the wide prefill: the same, then the dtype, then the stream
_WIDE_ARGTYPES = _ARGTYPES[:-1] + (_I, _P)
# kernel -> (library, C symbol, argtypes)
_SYMBOLS = {
    "f32": ("flash_attention", "flash_attention_launch", _ARGTYPES),
    "tc_prefill": ("flash_attention", "flash_attention_tc_launch", _ARGTYPES),
    "wide": ("flash_attention", "flash_attention_wide_launch",
             _WIDE_ARGTYPES),
    "decode": ("flash_decode", "flash_decode_launch", _ARGTYPES),
}
_fns = {}      # route -> its bound C function, once loaded
_sms = {}      # device index -> streaming multiprocessors


def route(q: torch.Tensor) -> str:
    """The kernel a call with this q goes to: ``"decode"`` for one query,
    else ``"tc_prefill"`` for bfloat16 and ``"f32"`` for float32."""
    if q.shape[2] == 1:
        return "decode"
    return "tc_prefill" if q.dtype == torch.bfloat16 else "f32"


def kernel_dim(d: int) -> int:
    """The kernel width that serves head dim ``d`` up to ``SLICED_ABOVE``:
    the next of ``HEAD_DIMS + WIDE_HEAD_DIMS``.  The columns past ``d``
    read as zeros, which add exact zeros to every q.k, and are not
    stored.  Above it the width of the k-slices (prefill) and passes
    (decode) that walk ``d``: :func:`wide_tiling`, :func:`decode_tiling`."""
    if d < 1:
        raise ValueError(f"head dim {d} is below 1")
    if d > SLICED_ABOVE:
        raise ValueError(f"head dim {d} is above {SLICED_ABOVE}: it is "
                         "walked in slices (wide_tiling, decode_tiling)")
    return -(-d // 16) * 16 if d <= 128 else -(-d // 32) * 32


def wide_tiling(d: int) -> Tuple[int, int, int]:
    """``(k-slices, columns of v and o a block covers, column blocks)`` of
    the wide prefill at head dim ``d``: S sums ``ceil(d / WIDE_SLICE)``
    k-slices; each of the ``WIDE_GROUPS`` warpgroups holds half of d's
    chunks of ``WIDE_SLICE`` columns, from 2 to ``WIDE_MAX_CHUNKS``, so a
    block covers all of d up to 512, and the grid's column blocks, each
    computing S again, cover the rest."""
    slices = -(-d // WIDE_SLICE)
    chunks = min(WIDE_MAX_CHUNKS, max(2, -(-slices // WIDE_GROUPS)))
    per_block = WIDE_GROUPS * chunks * WIDE_SLICE
    return slices, per_block, -(-d // per_block)


def wide_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Shared memory of one wide prefill block at head dim ``d``
    (``csrc/flash_attention.cu``, ``wide::Layout``): in bf16 up to D 512
    Q's slices resident (8 of 8 KB), then each warpgroup's ring of 6
    stages of a K slice; above 512 stages of a Q and a K slice; in float32
    2 stages of float32 Q and K slices beside 4 bf16 pair tiles; the two
    warpgroups' halves of S (64 x 64 float32 each), the mbarriers, 1024
    bytes of slack."""
    tile = 64 * WIDE_SLICE * (4 if dtype == torch.float32 else 2)
    if dtype == torch.float32:
        rings, parts, resident = 2 * 2 * tile, 4 * 64 * WIDE_SLICE * 2, 0
    else:
        qr = d <= WIDE_GROUPS * WIDE_MAX_CHUNKS * WIDE_SLICE
        rings, parts = 6 * (1 if qr else 2) * tile, 0
        resident = WIDE_GROUPS * WIDE_MAX_CHUNKS * tile if qr else 0
    stages = 2 if dtype == torch.float32 else 6
    return (1024 + resident + WIDE_GROUPS * (rings + parts)
            + WIDE_GROUPS * 16384 + WIDE_GROUPS * stages * 16 + 8)


def decode_tiling(d: int, group: int) -> Tuple[int, int, int]:
    """``(passes over a key row, column groups of v and o, slices of the
    query group)`` of the decode kernel at head dim ``d`` with ``group``
    query heads a KV head: one pass and one column group up to
    ``SLICED_ABOVE``, else ``ceil(d / DECODE_PASS)`` of each; the group in
    slices of ``MAX_GROUP`` heads."""
    n = 1 if d <= SLICED_ABOVE else -(-d // DECODE_PASS)
    return n, n, -(-group // MAX_GROUP)


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
        lib, symbol, argtypes = _SYMBOLS[name]
        fn = _fns[name] = _cuda.launcher(lib, argtypes, symbol=symbol)
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
    if D < 1:
        raise ValueError(f"flash_attention_cuda: head dim {D} is below 1")
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
    if B == 0 or Hq == 0 or Sq == 0:
        return torch.empty((B, Hq, Sq, D), dtype=dtype, device=dev)
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    # the kernels read rows of whole 16-byte units and fill the columns up
    # to their width with zeros; a row off those units is copied, padded
    # with zero columns (exact: they add zeros to every q.k), and the
    # output's padding sliced off
    unit = 16 // q.element_size()
    Dp = -(-D // unit) * unit
    if Dp != D:
        pad = (0, Dp - D)
        q, k, v = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
        qs, ks, vs = q.stride(), k.stride(), v.stride()
    out = torch.empty((B, Hq, Sq, Dp), dtype=dtype, device=dev)
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
                                Hq * Sq * Dp, Sq * Dp, Dp))
    wide = which != "decode" and Dp > WIDE_PREFILL_ABOVE[dtype]
    fn = _launcher("wide" if wide else which)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv)
    index = dev.index
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        stream = torch._C._cuda_getCurrentRawStream(index)
        if which == "decode":
            n_split = decode_splits(B * Hkv, Skv, _sm_count(dev))
            err = fn(*head, Skv, Dp, n_split, strides.buffer_info()[0],
                     scale, _DTYPES.index(dtype), stream)
        elif wide:
            err = fn(*head, Sq, Skv, Dp, strides.buffer_info()[0], scale,
                     int(causal), _DTYPES.index(dtype), stream)
        else:
            err = fn(*head, Sq, Skv, Dp, strides.buffer_info()[0], scale,
                     int(causal), stream)
    _cuda.check(f"flash_attention ({which})", err)
    _cuda.add_launch(__name__, which, "wide_launches" if wide else None)
    return out if Dp == D else out[..., :D].contiguous()
