"""Zarr-like hierarchical array storage over a snapshot manifest.

A *store session* exposes groups and arrays addressed by ``/``-paths.  Array
metadata (shape, dtype, chunk grid, attrs) lives in the snapshot document;
chunk payloads are content-addressed immutable objects.  Reads are lazy and
chunk-granular; writes stage into an open
:class:`~repro_torch.store.icechunk.Transaction`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .chunks import (ChunkGrid, normalize_selection, predicate_mask,
                     selection_bounds)
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


@dataclass
class ScanStats:
    """Chunk accounting for one :meth:`Array.scan` call."""

    n_chunks: int = 0       # candidate chunks examined
    n_pruned: int = 0       # skipped via chunk-statistics sidecars
    n_unwritten: int = 0    # no chunk object exists (fill value only)
    n_read: int = 0         # chunks actually fetched and decoded

    def merge(self, other: "ScanStats") -> None:
        self.n_chunks += other.n_chunks
        self.n_pruned += other.n_pruned
        self.n_unwritten += other.n_unwritten
        self.n_read += other.n_read


@dataclass
class ScanResult:
    """Matches of a predicate scan: global coordinates + values.

    ``coords`` is one int64 index array per axis; ``values`` the matching
    elements.  The ordering (chunks in grid order, row-major within each
    chunk) is deterministic and — because pruning only ever skips chunks
    that cannot contribute a match — identical for every pruning mode.
    """

    coords: Tuple[np.ndarray, ...]
    values: np.ndarray
    stats: ScanStats


def _stats_prune(st, value_gt: Optional[float],
                 value_lt: Optional[float]) -> bool:
    """True when a chunk's ``[min, max, valid]`` triple proves no match."""
    mn, mx, valid = st
    if not valid:  # no valid element at all
        return True
    if value_gt is not None and (mx is None or mx <= value_gt):
        return True
    if value_lt is not None and (mn is None or mn >= value_lt):
        return True
    return False


def _stats_prune_cid(session, path: str, cid, value_gt, value_lt) -> bool:
    """Whether one chunk's stat sidecar proves it cannot match."""
    st = session.chunk_stats(path, cid)
    return st is not None and _stats_prune(st, value_gt, value_lt)


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

    @property
    def chunks(self) -> Tuple[int, ...]:
        """Chunk grid — fixed at creation, rewritten only by the
        compaction maintenance pass (:mod:`repro_torch.store.compaction`)."""
        return self.meta.chunks

    @property
    def attrs(self) -> Dict[str, Any]:
        return self.meta.attrs

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

    def scan(
        self,
        selection=None,
        *,
        value_gt: Optional[float] = None,
        value_lt: Optional[float] = None,
        prune: bool = True,
        pushdown: bool = True,
    ) -> ScanResult:
        """Predicate scan with chunk-statistics pushdown.

        A *match* is a valid element (finite, for float dtypes) inside
        ``selection`` satisfying every value predicate.  With ``prune``
        the session's stat sidecars skip chunks that provably cannot
        match; with ``pushdown`` the chunk grid restricts candidates to
        chunks intersecting ``selection`` (when False, every chunk is a
        candidate and the selection is applied as a mask — the "blind
        scan" baseline).  All four mode combinations return bitwise-
        identical coords/values; only :class:`ScanStats` differ.  Multi-
        chunk scans fan out over the session's reader pool when one is
        configured.
        """
        shape = self.meta.shape
        sels = normalize_selection(selection, len(shape))
        bounds = selection_bounds(sels, shape)
        grid = self.meta.grid
        if pushdown:
            cids = list(grid.chunks_for_selection(
                [slice(b0, b1) for b0, b1 in bounds]
            ))
        else:
            cids = list(grid.chunk_ids())
        stats = ScanStats(n_chunks=len(cids))
        session = self._session
        is_float = np.issubdtype(self.dtype, np.floating)
        # only a NaN fill is invalid-by-definition; a finite float fill
        # (create_array allows one) makes unwritten chunks real matches
        fill_invalid = is_float and np.isnan(self.meta.fill_value)

        def scan_chunk(cid):
            if prune:
                st = session.chunk_stats(self.path, cid)
                if st is not None and _stats_prune(st, value_gt, value_lt):
                    return "pruned", None
            unwritten = (
                session.chunk_ref(self.path, cid) is None
                and session.staged_chunk_array(self.path, cid) is None
            )
            # never written: fill value only — a NaN fill is invalid by
            # definition, so nothing can match; any other fill means the
            # (synthesized, not decoded) fill chunk still has to be
            # tested against the predicates
            if unwritten and fill_invalid:
                return "unwritten", None
            chunk = self._read_chunk(cid)
            cslices = grid.chunk_slices(cid)
            mask = predicate_mask(chunk, [cs.start for cs in cslices],
                                  bounds, value_gt, value_lt)
            loc = np.nonzero(mask)
            coords = tuple(
                (l + cs.start).astype(np.int64)
                for l, cs in zip(loc, cslices)
            )
            return ("unwritten" if unwritten else "read"), (coords, chunk[loc])

        pool = session.reader_pool() if len(cids) > 1 else None
        if len(cids) > 1 and not session.writable:
            # batch the manifest + stat-sidecar round trips, then prefetch
            # only the chunks pruning cannot skip — so coalescing changes
            # GET counts, never the gated pruning fetch accounting
            session._prefetch_manifests([self.path], stats=prune)
            if prune:
                survivors = [
                    cid for cid in cids
                    if not _stats_prune_cid(session, self.path, cid,
                                            value_gt, value_lt)
                ]
            else:
                survivors = cids
            session.prefetch([(self.path, survivors)], wait=pool is None)
        if pool is None:
            outcomes = [scan_chunk(cid) for cid in cids]
        else:
            # pool.map preserves submission order, so the concatenation
            # below is deterministic regardless of completion order
            outcomes = list(pool.map(scan_chunk, cids))
        parts = []
        for kind, payload in outcomes:
            if kind == "pruned":
                stats.n_pruned += 1
            else:
                if kind == "unwritten":
                    stats.n_unwritten += 1
                else:
                    stats.n_read += 1
                if payload is not None and payload[1].size:
                    parts.append(payload)
        if parts:
            coords = tuple(
                np.concatenate([p[0][ax] for p in parts])
                for ax in range(len(shape))
            )
            values = np.concatenate([p[1] for p in parts])
        else:
            coords = tuple(
                np.empty(0, dtype=np.int64) for _ in range(len(shape))
            )
            values = np.empty(0, dtype=self.dtype)
        return ScanResult(coords, values, stats)

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
