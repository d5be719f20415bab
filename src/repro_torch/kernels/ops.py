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

from typing import Optional

import torch

from . import ref
from .grid_map import grid_map_cuda
from .grid_update import grid_update_cuda
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
    field: torch.Tensor,       # (time, gates) flattened polar block
    gate_idx: torch.Tensor,    # (cells, k) integer
    weights: torch.Tensor,     # (cells, k) float32
    *,
    mode: str = "auto",
) -> torch.Tensor:
    """Polar-to-grid gather-accumulate (kernel or plain version)."""
    if not _use_kernel(field, mode):
        return ref.grid_map(field, gate_idx, weights)
    return grid_map_cuda(field.to(torch.float32).contiguous(),
                         gate_idx.to(torch.int32).contiguous(),
                         weights.to(torch.float32).contiguous())


def grid_update(
    state: torch.Tensor,       # (time, cells) current product state
    upd: torch.Tensor,         # (time, touched) compact update block
    pos: torch.Tensor,         # (cells,) integer, < 0 = untouched
    *,
    op: str = "set",
    mode: str = "auto",
) -> torch.Tensor:
    """Incremental patch of a gridded product (kernel or plain version)."""
    if not _use_kernel(state, mode):
        return ref.grid_update(state, upd, pos, op=op)
    return grid_update_cuda(state.to(torch.float32).contiguous(),
                            upd.to(torch.float32).contiguous(),
                            pos.to(torch.int32).contiguous(), op=op)


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
