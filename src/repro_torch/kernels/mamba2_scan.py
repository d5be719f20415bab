"""Hand-written CUDA kernels: the chunked SSD scan of the Mamba-2 mixer.

The Hopper counterpart of the TPU kernel
``repro/kernels/mamba2_scan.py:mamba2_scan_pallas``.  Unlike the TPU
kernel it starts from an optional state ``h0``, so a serving step with a
state goes through it too.  The plain version is
:func:`repro_torch.kernels.ref.mamba2_scan`.  Four kernels stand behind
the one wrapper, and the route is chosen from the dtype, L and the state
width N alone (:func:`route`):

* ``"decode"`` (L == 1, float32 or bfloat16, N up to ``DECODE_MAX_N``):
  ``csrc/mamba2_decode.cu``, the state streamed row by row in 16-byte
  vectors;
* ``"chunk_tc"`` (L > 1, bfloat16, P and N up to 128):
  ``csrc/mamba2_scan.cu``'s ``mamba2_scan_tc_launch``, the chunks'
  products on the tensor cores (wgmma fed by TMA), every float32 operand
  as a bf16 pair; its plain version with the same roundings is
  :func:`repro_torch.kernels.ref.mamba2_scan_chunks`;
* ``"f32"`` (L > 1, float32, N up to 128): ``csrc/mamba2_scan.cu``'s
  ``mamba2_scan_launch``, chunk_tc's design with x, B and C split into
  bf16 pairs too, every product three bf16 products; its plain version
  with the same roundings is
  :func:`repro_torch.kernels.ref.mamba2_scan_chunks` on float32 inputs;
* ``"f32_wide"`` (float32, N above 128) and ``"bf16_wide"`` (bfloat16, P
  or N above 128), the widths no configuration of the repo has and the
  tensor-core kernels above do not hold in registers, and a one-token step
  with N above ``DECODE_MAX_N``: ``csrc/mamba2_scan.cu``'s
  ``mamba2_scan_wide_launch``, chunk_tc's frame (wgmma fed by TMA) with
  the roundings of the routes above but for one: in float32 the operands
  of the sums over N (S = C B^T and C h^T) and of y's (M o S) x go as
  three bf16 parts, since a pair misses the float32 tolerance in sums of
  a few hundred terms.  Its plain version with the same roundings is
  :func:`repro_torch.kernels.ref.mamba2_scan_chunks`, with ``parts=3`` in
  float32.  One kernel, one route name per dtype, any P and any N: a
  block takes a tile of ``N_SLICE`` columns of P, B and C pass through
  shared memory in slices of ``N_SLICE`` columns of N, and the state's
  slices stay in shared memory where they fit beside the rings, else in
  the output state in global memory (:func:`wide_tiling`).
"""

from __future__ import annotations

import array
import ctypes
from typing import Optional, Tuple

import torch

from . import _cuda

#: wrapper calls that launched a kernel since import (or since a caller
#: reset it to 0); one per scan, whatever the route
launches = 0
#: the same calls by route; they add up to ``launches``
route_launches = {"chunk_tc": 0, "decode": 0, "f32": 0, "f32_wide": 0,
                  "bf16_wide": 0}

#: dynamic shared memory a block may use on Hopper (bytes)
SMEM_LIMIT = 232448
#: the widest P and N the bf16 tensor-core route takes, and the widest N
#: of the float32 one (its tiles are 64 or 128)
TC_MAX_WIDTH = 128
#: the widest N the decode route takes (16 lanes a row, 16 values a lane)
DECODE_MAX_N = 256
_CHUNK = 64
#: columns of N in one slice of the B and C chunks on the wide routes, and
#: of P in one block's tile
N_SLICE = 64
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, dt, A, Bm, Cm, h0, y, hout, B, then (L, H, P, N) for a scan or (H, P,
# N) for decode, the int64 strides, the dtype, the stream
_SCAN_ARGS = (_P,) * 8 + (_I,) * 5 + (_P, _I, _P)
_DECODE_ARGS = (_P,) * 8 + (_I,) * 4 + (_P, _I, _P)
# route -> (library, C symbol, argtypes)
_SYMBOLS = {
    "f32": ("mamba2_scan", "mamba2_scan_launch", _SCAN_ARGS),
    "f32_wide": ("mamba2_scan", "mamba2_scan_wide_launch", _SCAN_ARGS),
    "bf16_wide": ("mamba2_scan", "mamba2_scan_wide_launch", _SCAN_ARGS),
    "chunk_tc": ("mamba2_scan", "mamba2_scan_tc_launch", _SCAN_ARGS),
    "decode": ("mamba2_decode", "mamba2_decode_launch", _DECODE_ARGS),
}
_fns = {}      # route -> its bound C function, once loaded


def route(x: torch.Tensor, n: int = 0) -> str:
    """The kernel a scan of this x (B, L, H, P) with a state width ``n``
    goes to: ``"decode"`` for one token with ``n`` up to
    ``DECODE_MAX_N``; else for bfloat16 ``"chunk_tc"``, or ``"bf16_wide"``
    where P or ``n`` is above ``TC_MAX_WIDTH``; for float32 ``"f32"``, or
    ``"f32_wide"`` where ``n`` is above ``TC_MAX_WIDTH``."""
    if x.shape[1] == 1 and n <= DECODE_MAX_N:
        return "decode"
    if x.dtype == torch.bfloat16:
        return ("bf16_wide" if max(x.shape[3], n) > TC_MAX_WIDTH
                else "chunk_tc")
    return "f32_wide" if n > TC_MAX_WIDTH else "f32"


def smem_bytes(N: int, dtype: torch.dtype = torch.bfloat16,
               resident: bool = True) -> int:
    """Shared memory one block of the wide routes needs at state width N,
    as ``csrc/mamba2_scan.cu``'s ``wide::Layout`` counts it: 1024 bytes of
    slack, the x stages and the B and C stages of 64-token tiles as loaded
    (two and three in bfloat16, one each in float32), the bf16 part tiles
    (h^T's pair in bfloat16; in float32 its three parts and x's, B's and
    C's), dt and each warp's L and dt, the mbarriers and, with the state
    ``resident``, its ``n_slices(N)`` slices of 64 x 64 float32.  Without
    it the bytes do not depend on N."""
    f32 = dtype == torch.float32
    tile = _CHUNK * N_SLICE * (4 if f32 else 2)
    stages_x, stages_bc = (1, 1) if f32 else (2, 3)
    parts = (12 if f32 else 2) * _CHUNK * N_SLICE * 2
    floats = stages_x * _CHUNK + 4 * 2 * _CHUNK
    fixed = (stages_x * tile + stages_bc * 2 * tile + parts + 4 * floats
             + 16 * (stages_x + stages_bc))
    return 1024 + fixed + (n_slices(N) * N_SLICE * N_SLICE * 4
                           if resident else 0)


def wide_tiling(P: int, N: int,
                dtype: torch.dtype = torch.bfloat16) -> Tuple[int, bool]:
    """``(columns of P one block takes, whether the state's slices stay in
    shared memory)`` on the wide routes, as ``csrc/mamba2_scan.cu``'s
    ``wide::launch`` chooses them: tiles of ``N_SLICE`` columns over the
    grid (P itself when narrower), the state resident where
    :func:`smem_bytes` fits ``SMEM_LIMIT``, else in global memory."""
    return (min(P, N_SLICE),
            smem_bytes(N, dtype, True) <= SMEM_LIMIT)


def wide_p_tile(P: int, N: int) -> int:
    """Columns of P one block of the wide routes takes
    (:func:`wide_tiling`)."""
    return wide_tiling(P, N)[0]


def n_slices(N: int) -> int:
    """Slices of ``N_SLICE`` columns the wide routes pass B and C in."""
    return -(-N // N_SLICE)


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib, symbol, argtypes = _SYMBOLS[name]
        fn = _fns[name] = _cuda.launcher(lib, argtypes, symbol=symbol)
    return fn


def _tma_ready(t: torch.Tensor, st) -> torch.Tensor:
    """``t`` itself when it starts on 16 bytes and its strides ``st`` (all
    but the last) are whole 16-byte units, as the TMA copies need; else a
    copy into rows padded to 8 values, sliced back to ``t``'s shape."""
    bad = t.data_ptr()
    for s in st[:-1]:
        bad |= s * t.element_size()
    if not bad & 15:
        return t
    last = t.shape[-1]
    buf = torch.empty((*t.shape[:-1], -(-last // 8) * 8), dtype=t.dtype,
                      device=t.device)
    view = buf[..., :last]
    view.copy_(t)
    return view


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
    dev = x.device
    if not (x.is_cuda and dt.device == dev and A.device == dev
            and Bmat.device == dev and Cmat.device == dev
            and (h0 is None or h0.device == dev)):
        for name, t in (("x", x), ("dt", dt), ("A", A), ("Bmat", Bmat),
                        ("Cmat", Cmat), ("h0", h0)):
            if t is not None and (t.device != dev or dev.type != "cuda"):
                raise ValueError(f"mamba2_scan_cuda: {name} must be a CUDA "
                                 f"tensor on {dev}, got {t.device}")
    # one test each for the types and the shapes; the loops that name
    # the culprit run only when a test fails
    dtype = x.dtype
    f32 = torch.float32
    if not (dtype in _DTYPES and Bmat.dtype == dtype and Cmat.dtype == dtype
            and dt.dtype == f32 and A.dtype == f32
            and (h0 is None or h0.dtype == f32)):
        if dtype not in _DTYPES or Bmat.dtype != dtype \
                or Cmat.dtype != dtype:
            raise TypeError("mamba2_scan_cuda: x, Bmat and Cmat must all be "
                            "float32 or all bfloat16, got "
                            f"{x.dtype}, {Bmat.dtype}, {Cmat.dtype}")
        for name, t in (("dt", dt), ("A", A), ("h0", h0)):
            if t is not None and t.dtype != f32:
                raise TypeError(f"mamba2_scan_cuda: {name} must be float32, "
                                f"got {t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"mamba2_scan_cuda: x must be (B, L, H, P), got "
                         f"{tuple(x.shape)}")
    Bsz, L, H, P = x.shape
    N = Bmat.shape[-1]
    if not (dt.shape == (Bsz, L, H) and A.shape == (H,)
            and Bmat.shape == (Bsz, L, N) and Cmat.shape == (Bsz, L, N)
            and (h0 is None or h0.shape == (Bsz, H, P, N))):
        want = {"dt": (Bsz, L, H), "A": (H,), "Bmat": (Bsz, L, N),
                "Cmat": (Bsz, L, N), "h0": (Bsz, H, P, N)}
        for name, t in (("dt", dt), ("A", A), ("Bmat", Bmat),
                        ("Cmat", Cmat), ("h0", h0)):
            if t is not None and tuple(t.shape) != want[name]:
                raise ValueError(f"mamba2_scan_cuda: {name} must be "
                                 f"{want[name]}, got {tuple(t.shape)}")
    xs, bs, cs = x.stride(), Bmat.stride(), Cmat.stride()
    if (P > 1 and xs[3] != 1) or (N > 1 and (bs[2] != 1 or cs[2] != 1)):
        raise ValueError("mamba2_scan_cuda: x, Bmat and Cmat need a "
                         "contiguous last dimension")
    which = route(x, N)
    if Bsz > 65535 or H > 65535:
        raise ValueError(f"mamba2_scan_cuda: B={Bsz} or H={H} above the "
                         "grid's 65535")
    if h0 is not None and not h0.is_contiguous():
        h0 = h0.contiguous()
    y = torch.empty((Bsz, L, H, P), dtype=dtype, device=dev)
    if Bsz == 0 or L == 0 or H == 0 or P == 0 or N == 0:
        # nothing to scan: the state is where it started
        h = (h0.clone() if h0 is not None
             else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                              device=dev))
        return y, h
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    if not A.is_contiguous():
        A = A.contiguous()
    ds = dt.stride()
    y_out = y
    if which != "decode":
        # the TMA copies want 16-byte units: copy what is not
        x, Bmat, Cmat = (_tma_ready(x, xs), _tma_ready(Bmat, bs),
                         _tma_ready(Cmat, cs))
        xs, bs, cs = x.stride(), Bmat.stride(), Cmat.stride()
        if which == "chunk_tc" and P % 2:
            # the kernel stores y in column pairs: rows of P + 1
            y_out = torch.empty((Bsz, L, H, P + 1), dtype=dtype, device=dev)
    if which == "decode":
        strides = array.array("q", (xs[0], xs[2], ds[0], ds[2], bs[0],
                                    cs[0]))
        shape = (H, P, N)
    else:
        strides = array.array("q", (*xs[:3], *ds, *bs[:2], *cs[:2]))
        shape = (L, H, P, N)
    fn = _launcher(which)
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(), None if h0 is None else h0.data_ptr(),
            y_out.data_ptr(), h.data_ptr(), Bsz, *shape,
            strides.buffer_info()[0], _DTYPES.index(dtype))
    index = dev.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    _cuda.check(f"mamba2_scan ({which})", err)
    _cuda.add_launch(__name__, which)
    if y_out is not y:
        y.copy_(y_out[..., :P])
    return y, h
