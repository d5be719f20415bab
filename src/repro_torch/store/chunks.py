"""Chunk-grid math, codecs, and content addressing.

Zarr's core idea — fixed chunk grids over n-d arrays, each chunk an
independently compressed object — is what aligns storage layout with access
patterns.  The radar archive uses time × azimuth × range chunks; a product
reads exactly the chunks under its selection.

The encoding (C-order bytes through a named codec) and the content hash
are those of the reference package, so both packages address the same
chunk payloads by the same keys.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .codecs import get_codec


def compress(raw: bytes, codec: Optional[str] = None) -> bytes:
    """Compress raw bytes with the named (or default) codec."""
    return get_codec(codec).encode(raw)


def decompress(blob: bytes, codec: Optional[str] = None) -> bytes:
    """Invert :func:`compress`."""
    return get_codec(codec).decode(blob)


def content_hash(blob: bytes) -> str:
    """Content address: sha256 truncated to 128 bits (hex)."""
    return hashlib.sha256(blob).hexdigest()[:32]


@dataclass(frozen=True)
class ChunkGrid:
    """Regular chunk grid over an n-d array (last chunks may be partial)."""

    shape: Tuple[int, ...]
    chunks: Tuple[int, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.chunks):
            raise ValueError("shape/chunks rank mismatch")
        if any(c <= 0 for c in self.chunks):
            raise ValueError("chunk sizes must be positive")

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return tuple(
            max(1, math.ceil(s / c)) for s, c in zip(self.shape, self.chunks)
        )

    def n_chunks(self) -> int:
        return int(np.prod(self.grid_shape))

    def chunk_ids(self) -> Iterator[Tuple[int, ...]]:
        yield from np.ndindex(*self.grid_shape)

    def chunk_slices(self, cid: Sequence[int]) -> Tuple[slice, ...]:
        return tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(cid, self.chunks, self.shape)
        )

    def chunk_shape(self, cid: Sequence[int]) -> Tuple[int, ...]:
        return tuple(sl.stop - sl.start for sl in self.chunk_slices(cid))

    def chunks_for_selection(
        self, selection: Sequence[slice]
    ) -> Iterator[Tuple[int, ...]]:
        """Chunk ids intersecting an orthogonal slice selection.

        This is the partial-read primitive behind the paper's speedups:
        a QVP touching one sweep/one variable reads only the chunks under
        its (time, azimuth, range) selection instead of decoding whole
        volume files.
        """
        ranges = []
        for sl, c, s in zip(selection, self.chunks, self.shape):
            start, stop, step = sl.indices(s)
            if step != 1:
                raise NotImplementedError("strided chunk selection")
            if stop <= start:
                return
            ranges.append(range(start // c, (stop - 1) // c + 1))
        for offsets in np.ndindex(*[len(r) for r in ranges]):
            yield tuple(r[o] for r, o in zip(ranges, offsets))


def plan_time_chunks(
    shape: Sequence[int],
    chunks: Sequence[int],
    itemsize: int,
    target_bytes: int,
) -> Tuple[int, ...]:
    """Analysis-optimized leading-axis (time) chunk length.

    Chosen under a byte budget.

    Append-heavy ingest leaves an archive with many short time chunks;
    this plans the tall replacement the compaction pass rewrites them
    into.  The planned chunk is at least the current one (compaction only
    merges along time, never splits), a multiple of it while that keeps
    several chunks (so old chunk boundaries nest inside new ones and the
    rewrite copies each old chunk exactly once), and capped at the array
    extent.  Arrays that already fit in one time chunk come back
    unchanged — the no-op the idempotence of compaction relies on.
    """
    shape = tuple(shape)
    chunks = tuple(chunks)
    if not shape or shape[0] <= 0:
        return chunks
    if math.ceil(shape[0] / chunks[0]) <= 1:
        return chunks  # a single time chunk cannot be merged further
    row_bytes = itemsize
    for s, c in zip(shape[1:], chunks[1:]):
        row_bytes *= max(1, min(c, s))
    t = max(1, target_bytes // max(1, row_bytes))
    if t >= shape[0]:
        t = shape[0]
    else:
        t = max(chunks[0], (t // chunks[0]) * chunks[0])
    return (int(t),) + chunks[1:]


def normalize_selection(selection, ndim: int) -> list:
    """Canonical per-axis selector list.

    None → all, scalar → 1-tuple, short tuples padded with full slices."""
    if selection is None:
        return [slice(None)] * ndim
    if not isinstance(selection, tuple):
        selection = (selection,)
    return list(selection) + [slice(None)] * (ndim - len(selection))


def selection_bounds(sels: Sequence,
                     shape: Sequence[int]) -> list:
    """Normalize a selection to per-axis ``(start, stop)`` bounds.

    Integers become length-1 ranges (with negative-index wrapping and
    bounds checking), exactly as ``Array.__getitem__`` treats them.
    Strided selections are rejected here — the single choke point for
    every scan path (lazy and eager), so they cannot drift apart — just
    as :meth:`ChunkGrid.chunks_for_selection` rejects them for reads.
    """
    bounds = []
    for ax, (sl, dim) in enumerate(zip(sels, shape)):
        if isinstance(sl, (int, np.integer)):
            i = int(sl) + (dim if sl < 0 else 0)
            if not 0 <= i < dim:
                raise IndexError(
                    f"index {int(sl)} out of bounds for axis {ax} "
                    f"with size {dim}"
                )
            bounds.append((i, i + 1))
            continue
        b0, b1, step = sl.indices(dim)
        if step != 1:
            raise NotImplementedError("strided chunk selection")
        bounds.append((b0, b1))
    return bounds


def predicate_mask(a: np.ndarray, offsets: Sequence[int],
                   bounds: Sequence[Tuple[int, int]],
                   value_gt: Optional[float] = None,
                   value_lt: Optional[float] = None) -> np.ndarray:
    """Match mask over one block: valid ∧ inside bounds ∧ value predicates.

    ``a`` is a block whose element ``[i, j, ...]`` sits at global index
    ``offsets + (i, j, ...)``; *valid* means finite for float dtypes.
    This is the one definition of "match" shared by the chunk scan
    (:meth:`repro_torch.store.Array.scan`).
    """
    mask = (np.isfinite(a) if np.issubdtype(a.dtype, np.floating)
            else np.ones(a.shape, dtype=bool))
    for ax, (off, (b0, b1)) in enumerate(zip(offsets, bounds)):
        idx = np.arange(off, off + a.shape[ax])
        ax_ok = (idx >= b0) & (idx < b1)
        mask &= ax_ok.reshape(
            tuple(-1 if i == ax else 1 for i in range(a.ndim))
        )
    if value_gt is not None:
        mask &= a > value_gt
    if value_lt is not None:
        mask &= a < value_lt
    return mask


def chunk_stats_summary(arr) -> list:
    """Per-chunk statistics triple ``[min, max, valid_fraction]``.

    The triple is the chunk-statistics sidecar payload (snapshot format
    v3) that query planners use for predicate pushdown.  *Valid* means
    finite for floating dtypes (NaN is the fill/missing sentinel
    throughout the archive) and every element otherwise; ``min``/``max``
    are taken over valid elements only and serialize to JSON ``null``
    when the chunk holds no valid value.  Stats are computed on the full
    *padded* chunk.  Sidecars are content-addressed and referenced from
    the snapshot, so this must match the reference package exactly for
    snapshot ids to agree.
    """
    a = np.asarray(arr)
    if a.size == 0:
        return [None, None, 0.0]
    if np.issubdtype(a.dtype, np.floating):
        valid = np.isfinite(a)
        n = int(np.count_nonzero(valid))
        if n == 0:
            return [None, None, 0.0]
        vals = a[valid]
        return [float(vals.min()), float(vals.max()), n / a.size]
    return [float(a.min()), float(a.max()), 1.0]


def encode_chunk(arr: np.ndarray, codec: Optional[str] = None) -> bytes:
    """Serialize one chunk: C-order raw bytes through the named codec."""
    return compress(np.ascontiguousarray(arr).tobytes(), codec)


def decode_chunk(
    blob: bytes,
    shape: Tuple[int, ...],
    dtype,
    codec: Optional[str] = None,
    *,
    writable: bool = True,
) -> np.ndarray:
    """Decode a stored blob back into an ndarray of ``shape``/``dtype``."""
    raw = decompress(blob, codec)
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    if writable:
        return arr.copy()
    # read-only view over the decompressed buffer (zero-copy for ``raw``);
    # the session chunk cache shares these across readers, so they must
    # stay immutable
    return arr
