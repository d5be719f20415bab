"""Public kernel entry points: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.

``mode`` semantics:
  * ``"auto"``   — the hand-written kernel for a CUDA tensor; the plain
                   version only for a CPU tensor, which the caller chose
  * ``"kernel"`` — force the kernel; a CPU tensor raises (a CUDA kernel
                   has no interpret mode)
  * ``"ref"``    — force the plain version, on whatever device the input is
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .flash_attention import flash_attention_cuda
from .grid_map import CellOrder, grid_map_cuda
from .grid_update import grid_scatter_cuda
from .mamba2_scan import mamba2_scan_cuda
from .qvp_reduce import qvp_reduce_cuda
from .zr_accum import zr_accum_cuda


def _use_kernel(x: torch.Tensor, mode: str) -> bool:
    if mode == "ref":
        return False
    if mode == "kernel":
        if x.device.type != "cuda":
            raise RuntimeError(
                f"mode='kernel' needs a CUDA tensor, got one on {x.device}: "
                "the hand-written kernels run only on the GPU"
            )
        return True
    if mode == "auto":
        return x.device.type == "cuda"
    raise ValueError(f"unknown mode {mode!r}")


def qvp_reduce(
    field: torch.Tensor,
    quality: Optional[torch.Tensor] = None,
    *,
    quality_min: float = 0.85,
    min_valid_fraction: float = 0.1,
    mode: str = "auto",
) -> torch.Tensor:
    """Quality-masked azimuthal QVP reduction (kernel or plain version)."""
    if not _use_kernel(field, mode):
        return ref.qvp_reduce(field, quality, quality_min=quality_min,
                              min_valid_fraction=min_valid_fraction)
    if quality is None:
        # quality := field with an always-pass threshold keeps one kernel
        quality, quality_min = field, float("-inf")
    return qvp_reduce_cuda(field.to(torch.float32).contiguous(),
                           quality.to(torch.float32).contiguous(),
                           quality_min=float(quality_min),
                           min_valid_fraction=min_valid_fraction)


def grid_map(
    field,                     # (time, gates) tensor, or a sequence of S
    gate_idx: torch.Tensor,    # (cells, k) or (cells, S, k) integer
    weights: torch.Tensor,     # the same shape, float32
    *,
    order: Optional[CellOrder] = None,
    mode: str = "auto",
) -> torch.Tensor:
    """Polar-to-grid gather-accumulate over S sweeps, folded by a NaN-aware
    max, in one launch (kernel or plain version).

    ``field`` is one (time, gates) block with a (cells, k) map, or the S
    sweeps' blocks with a (cells, S, k) map.  With ``order`` (a checked
    permutation, from :func:`repro_torch.kernels.grid_map.cell_order`),
    map row i writes column ``order.cells[i]``, and rows from
    ``order.n_live`` on must have no live slot: the kernel trusts that
    promise, the plain version raises on a broken one."""
    fields = [field] if isinstance(field, torch.Tensor) else list(field)
    if not fields:
        raise ValueError("grid_map needs at least one field")
    if not _use_kernel(fields[0], mode):
        return ref.grid_map(fields, gate_idx, weights, order=order)
    if gate_idx.dim() == 2:
        gate_idx, weights = gate_idx[:, None, :], weights[:, None, :]
    return grid_map_cuda(
        [f.to(torch.float32).contiguous() for f in fields],
        gate_idx.to(torch.int32).contiguous(),
        weights.to(torch.float32).contiguous(),
        None if order is None else order.cells,
        None if order is None else order.n_live)


def grid_scatter_(
    state: torch.Tensor,       # (time, cells) float32 state, patched in place
    upd: torch.Tensor,         # (time, touched) compact update block
    cells: torch.Tensor,       # (touched,) integer, strictly increasing
    *,
    op: str = "set",
    mode: str = "auto",
) -> torch.Tensor:
    """In-place incremental patch of a gridded product at an ascending
    cell list (kernel or plain version); returns ``state``.

    The reference's ``grid_update`` with ``pos[cells[j]] = j``, without
    the (C,) map: only the touched cells are read and written.  ``state``
    must be a contiguous float32 tensor (it is not copied).  ``cells``
    **must** be strictly increasing and in ``[0, C)``: the kernel writes
    each cell from one thread and does not check the list (a repeated
    cell would race), so a caller that cannot promise it must not call
    this; the plain version raises ``ValueError`` on a bad list."""
    if not _use_kernel(state, mode):
        return ref.grid_scatter_(state, upd, cells, op=op)
    return grid_scatter_cuda(state, upd.to(torch.float32).contiguous(),
                             cells.to(torch.int32).contiguous(), op=op)


def zr_accum(
    dbz: torch.Tensor,
    dt_s: torch.Tensor,
    *,
    a: float = 200.0,
    b: float = 1.6,
    dbz_min: float = 5.0,
    dbz_max: float = 53.0,
    mode: str = "auto",
) -> torch.Tensor:
    """Z–R rainfall accumulation (kernel or plain version)."""
    if not _use_kernel(dbz, mode):
        return ref.zr_accum(dbz, dt_s, a=a, b=b, dbz_min=dbz_min,
                            dbz_max=dbz_max)
    return zr_accum_cuda(dbz.to(torch.float32).contiguous(),
                         dt_s.to(torch.float32).contiguous(),
                         a=a, b=b, dbz_min=dbz_min, dbz_max=dbz_max)


def flash_attention(
    q: torch.Tensor,           # (B, Hq, Sq, D)
    k: torch.Tensor,           # (B, Hkv, Skv, D)
    v: torch.Tensor,           # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    mode: str = "auto",
) -> torch.Tensor:
    """Flash attention (kernel or plain version).  The kernel reads q, k
    and v through their strides (a slice of a KV cache is not copied)."""
    if not _use_kernel(q, mode):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale)


def mamba2_scan(
    x: torch.Tensor,           # (B, L, H, P)
    dt: torch.Tensor,          # (B, L, H)
    A: torch.Tensor,           # (H,)
    Bmat: torch.Tensor,        # (B, L, N)
    Cmat: torch.Tensor,        # (B, L, N)
    *,
    h0: Optional[torch.Tensor] = None,   # (B, H, P, N)
    mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 selective scan (kernel or plain version) -> (y, final
    state).  Unlike the reference's ``ops.mamba2_scan``, a given ``h0``
    goes to the kernel too: it starts its carried state there, which is
    the function ``ref.mamba2_scan(..., h0=h0)`` computes."""
    if not _use_kernel(x, mode):
        return ref.mamba2_scan(x, dt, A, Bmat, Cmat, h0=h0)
    return mamba2_scan_cuda(
        x, dt.to(torch.float32), A.to(torch.float32), Bmat.to(x.dtype),
        Cmat.to(x.dtype), h0=None if h0 is None else h0.to(torch.float32))
