"""Zarr-like hierarchical array storage over a snapshot manifest.

A *store session* exposes groups and arrays addressed by ``/``-paths.  Array
metadata (shape, dtype, chunk grid, attrs) lives in the snapshot document;
chunk payloads are content-addressed immutable objects.  Reads are lazy and
chunk-granular; writes stage into an open
:class:`~repro_torch.store.icechunk.Transaction`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Sequence, Tuple

import numpy as np

from .chunks import ChunkGrid
from .codecs import default_codec


@dataclass
class ArrayMeta:
    """Array metadata: shape, dtype, chunk grid, fill and codec."""
    shape: Tuple[int, ...]
    dtype: str
    chunks: Tuple[int, ...]
    attrs: Dict[str, Any] = field(default_factory=dict)
    fill_value: float = float("nan")
    codec: str = field(default_factory=default_codec)

    def to_doc(self) -> Dict[str, Any]:
        return {
            "shape": list(self.shape),
            "dtype": self.dtype,
            "chunks": list(self.chunks),
            "attrs": self.attrs,
            "fill_value": None if np.isnan(self.fill_value) else self.fill_value,
            "codec": self.codec,
        }

    @staticmethod
    def from_doc(doc: Dict[str, Any]) -> "ArrayMeta":
        fv = doc.get("fill_value")
        return ArrayMeta(
            shape=tuple(doc["shape"]),
            dtype=doc["dtype"],
            chunks=tuple(doc["chunks"]),
            attrs=dict(doc.get("attrs", {})),
            fill_value=float("nan") if fv is None else float(fv),
            # snapshots written before codecs were pluggable used zstd
            codec=doc.get("codec", "zstd"),
        )

    @property
    def grid(self) -> ChunkGrid:
        return ChunkGrid(self.shape, self.chunks)


def _chunk_key(cid: Sequence[int]) -> str:
    return "c" + "/".join(str(i) for i in cid) if cid else "c0"


class Array:
    """Lazy chunked array bound to a snapshot (read) or transaction (write)."""

    def __init__(self, session, path: str, meta: ArrayMeta):
        self._session = session
        self.path = path
        self.meta = meta

    # -- reads -------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.meta.shape

    @property
    def dtype(self):
        return np.dtype(self.meta.dtype)

    def _normalize_int(self, ax: int, s: int) -> int:
        dim = self.meta.shape[ax]
        if s < 0:
            s += dim
        if not 0 <= s < dim:
            raise IndexError(
                f"index {s} out of bounds for axis {ax} with size {dim}"
            )
        return s

    def __getitem__(self, selection) -> np.ndarray:
        if not isinstance(selection, tuple):
            selection = (selection,)
        # normalize: ints become length-1 slices (squeezed at the end)
        squeeze_axes = []
        sels = []
        for ax, s in enumerate(selection):
            if isinstance(s, (int, np.integer)):
                s = self._normalize_int(ax, int(s))
                sels.append(slice(s, s + 1))
                squeeze_axes.append(ax)
            else:
                sels.append(s)
        while len(sels) < len(self.meta.shape):
            sels.append(slice(None))
        bounds = [sl.indices(dim) for sl, dim in zip(sels, self.meta.shape)]
        out_shape = tuple(max(0, b[1] - b[0]) for b in bounds)
        out = np.full(out_shape, self.meta.fill_value, dtype=self.dtype)
        grid = self.meta.grid

        def fill_from(cid) -> None:
            cslices = grid.chunk_slices(cid)
            chunk = self._read_chunk(cid)
            # intersection of chunk extent and request, in both frames
            src, dst = [], []
            for (cs, b) in zip(cslices, bounds):
                lo = max(cs.start, b[0])
                hi = min(cs.stop, b[1])
                src.append(slice(lo - cs.start, hi - cs.start))
                dst.append(slice(lo - b[0], hi - b[0]))
            out[tuple(dst)] = chunk[tuple(src)]

        cids = list(grid.chunks_for_selection(sels))
        pool = self._session.reader_pool() if len(cids) > 1 else None
        if len(cids) > 1:
            # coalesce the multi-chunk read into batched GETs up front —
            # with a pool the batches overlap the fills below (which wait
            # on in-flight chunks instead of re-fetching); without one the
            # fills run against a warm cache.  Writable sessions no-op.
            self._session.prefetch([(self.path, cids)], wait=pool is None)
        if pool is None:
            for cid in cids:
                fill_from(cid)
        else:
            # destination regions are disjoint per chunk, so concurrent
            # fills never overlap; store get + codec decode release the GIL
            list(pool.map(fill_from, cids))
        if squeeze_axes:
            out = np.squeeze(out, axis=tuple(squeeze_axes))
        return out

    def read(self) -> np.ndarray:
        return self[tuple(slice(None) for _ in self.meta.shape)]

    def _read_chunk(self, cid) -> np.ndarray:
        """Read one chunk at its *actual* (possibly edge-clipped) extent.

        Chunks are always persisted at the full chunk shape, padded with
        ``fill_value`` at array edges — this keeps appends (resize + write)
        valid without rewriting boundary chunks.
        """
        full = self._read_chunk_padded(cid)
        actual = self.meta.grid.chunk_shape(cid)
        return full[tuple(slice(0, s) for s in actual)]

    def _read_chunk_padded(self, cid, *, writable: bool = False) -> np.ndarray:
        """Full padded chunk.  The default return may be a **read-only**
        array shared via the session's chunk cache; pass ``writable=True``
        to get a private mutable copy (the RMW write path)."""
        staged = self._session.staged_chunk_array(self.path, cid)
        if staged is not None:
            return staged  # already private to this transaction
        chunk = self._session.decoded_chunk(self.path, cid, self.meta)
        if chunk is None:
            return np.full(self.meta.chunks, self.meta.fill_value,
                           dtype=self.dtype)
        return chunk.copy() if writable else chunk

    # -- writes (require an open transaction) ------------------------------
    def __setitem__(self, selection, value) -> None:
        if not isinstance(selection, tuple):
            selection = (selection,)
        sels = list(selection)
        while len(sels) < len(self.meta.shape):
            sels.append(slice(None))
        norm = []
        for ax, s in enumerate(sels):
            if isinstance(s, (int, np.integer)):
                i = self._normalize_int(ax, int(s))
                norm.append(slice(i, i + 1))
            else:
                norm.append(s)
        sels = norm
        bounds = [sl.indices(dim) for sl, dim in zip(sels, self.meta.shape)]
        value = np.asarray(value, dtype=self.dtype)
        req_shape = tuple(max(0, b[1] - b[0]) for b in bounds)
        value = np.broadcast_to(value, req_shape)
        grid = self.meta.grid
        for cid in grid.chunks_for_selection(sels):
            cslices = grid.chunk_slices(cid)
            src, dst = [], []
            full_cover = True
            for (cs, b, full_c) in zip(cslices, bounds, self.meta.chunks):
                lo = max(cs.start, b[0])
                hi = min(cs.stop, b[1])
                if lo > cs.start or (hi - lo) < full_c:
                    full_cover = False
                dst.append(slice(lo - cs.start, hi - cs.start))
                src.append(slice(lo - b[0], hi - b[0]))
            if full_cover:
                # the request covers the whole chunk: no read needed, but
                # always stage a private, writable copy of the caller's data
                chunk = np.array(value[tuple(src)], dtype=self.dtype,
                                 order="C")
            else:
                # read-modify-write at full padded chunk shape; an already
                # staged chunk is mutated in place, so repeated appends to
                # one time chunk pay the codec exactly once, at commit
                chunk = self._read_chunk_padded(cid, writable=True)
                chunk[tuple(dst)] = value[tuple(src)]
            self._session.stage_chunk_array(self.path, cid, chunk)

    def write_full(self, value: np.ndarray) -> None:
        self[tuple(slice(None) for _ in self.meta.shape)] = value
