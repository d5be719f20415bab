"""Transactional, versioned storage engine over the object store.

The Icechunk design the archive relies on, with the snapshot, manifest
and stat-sidecar formats of the reference package, so snapshot ids agree
and either package reads the other's archives:

* **Immutable, content-addressed chunks** — every chunk payload is stored
  once under its sha256 address.
* **Sharded per-array manifests** — each array's ``chunk id → content
  hash`` map is split into content-addressed shards by leading (time)
  chunk index (format v2); the single-manifest v1 format is read too.
* **Chunk-statistics sidecars** (format v3) — commits write per-chunk
  ``[min, max, valid_fraction]`` triples next to the manifest shards.
* **Cached, concurrent reads** — every session carries an LRU decoded-
  chunk cache plus a manifest-object cache, and a prefetch plan that
  coalesces chunk fetches into batches (optionally on a reader pool).
* **Snapshots** — content hashes of the canonical document (wall-clock
  ``written_at`` excluded), so the same data produces the same id.
* **Atomic commits** — a branch ref flips from parent to child via
  compare-and-swap.  A commit that loses the swap raises
  :class:`ConflictError`; rebasing onto the new head is not ported yet.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .chunks import (chunk_stats_summary, content_hash, decode_chunk,
                     encode_chunk, normalize_selection)
from .codecs import get_codec, json_dumps, json_loads
from .object_store import ObjectStore
from .zarrlite import Array, ArrayMeta, _chunk_key


class ConflictError(RuntimeError):
    """A concurrent commit moved the branch under this transaction."""


class NotFound(KeyError):
    """Missing key/array/snapshot lookup (a ``KeyError``)."""


# canonical JSON (stdlib, sorted keys, compact) — the hashed byte encoding
_dumps = json_dumps
_loads = json_loads

# wall-clock metadata excluded from the snapshot's content address
_VOLATILE_SNAPSHOT_FIELDS = ("written_at",)

# time-chunks per manifest shard — a format constant shared with the
# reference package: it decides which shard a chunk key belongs to
MANIFEST_SHARD_CHUNKS = 8

# decoded-chunk LRU budget per session (bytes)
DEFAULT_CACHE_BYTES = 128 << 20
# manifest-shard/manifest-object LRU entries per session
_OBJ_CACHE_ENTRIES = 1024
# chunk payloads per coalesced GET batch
PREFETCH_BATCH_KEYS = 16
# how long a demand read waits for an in-flight prefetch of the same chunk
# before falling back to a direct fetch
_INFLIGHT_WAIT_S = 15.0


@dataclass
class PrefetchReport:
    """Outcome of one :meth:`Session.prefetch` plan.

    ``planned`` counts the distinct committed chunk payloads the plan
    covered; each is then ``cached`` (already resident), ``inflight``
    (another plan is fetching it), ``deferred`` (left to demand reads by
    the cache budget), or ``scheduled`` into one of ``batches`` GET
    batches.
    """

    planned: int = 0
    scheduled: int = 0
    cached: int = 0
    inflight: int = 0
    deferred: int = 0
    batches: int = 0
    _jobs: List[Any] = field(default_factory=list, repr=False)

    def wait(self) -> "PrefetchReport":
        """Block until every scheduled fetch batch has landed."""
        jobs, self._jobs = self._jobs, []
        for job in jobs:
            job.result()
        return self


def _shard_index(chunk_key: str) -> int:
    """Manifest shard holding ``chunk_key`` ("c<i0>/<i1>/...")."""
    first = chunk_key[1:].split("/", 1)[0]
    return int(first) // MANIFEST_SHARD_CHUNKS


class Repository:
    """A versioned archive: the durable half of a Radar DataTree."""

    def __init__(self, store: ObjectStore):
        self.store = store

    @staticmethod
    def _coerce_store(store_or_path):
        if isinstance(store_or_path, (str, os.PathLike)):
            return ObjectStore(store_or_path)
        return store_or_path

    @classmethod
    def create(cls, store_or_path, *, branch: str = "main") -> "Repository":
        repo = cls(cls._coerce_store(store_or_path))
        empty = {
            "parent": None,
            "message": "repository created",
            "groups": {"": {}},
            "arrays": {},
            "manifests": {},
        }
        sid = repo._write_snapshot(empty)
        if not repo.store.compare_and_swap(
            repo._ref_key(branch), None, _dumps({"snapshot": sid})
        ):
            raise RuntimeError(f"branch {branch!r} already exists")
        return repo

    @classmethod
    def open(cls, store_or_path) -> "Repository":
        return cls(cls._coerce_store(store_or_path))

    @staticmethod
    def _ref_key(branch: str) -> str:
        return f"refs/branch.{branch}.json"

    def branch_head(self, branch: str = "main") -> str:
        try:
            return _loads(self.store.get(self._ref_key(branch)))["snapshot"]
        except KeyError:
            raise NotFound(f"branch {branch!r}") from None

    def _write_snapshot(self, doc: Dict[str, Any]) -> str:
        hashable = {
            k: v for k, v in doc.items() if k not in _VOLATILE_SNAPSHOT_FIELDS
        }
        sid = content_hash(_dumps(hashable))
        self.store.put(f"snapshots/{sid}.json", _dumps(doc), if_not_exists=True)
        return sid

    def _read_snapshot(self, sid: str) -> Dict[str, Any]:
        try:
            return _loads(self.store.get(f"snapshots/{sid}.json"))
        except KeyError:
            raise NotFound(f"snapshot {sid}") from None

    def readonly_session(
        self, *, branch: str = "main", snapshot_id: Optional[str] = None,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        read_workers: int = 1,
    ) -> "Session":
        if snapshot_id is None:
            snapshot_id = self.branch_head(branch)
        return Session(self, snapshot_id, writable=False,
                       cache_bytes=cache_bytes, read_workers=read_workers)

    def writable_session(self, branch: str = "main",
                         **session_kw) -> "Transaction":
        return Transaction(self, branch, self.branch_head(branch),
                           **session_kw)


class Session:
    """Read view pinned to one snapshot (snapshot isolation).

    Carries two LRU caches shared by all arrays it opens — decoded chunks
    (budgeted in bytes) and manifest objects (budgeted in entries) — plus
    an optional reader thread pool (``read_workers``) that multi-chunk
    reads and prefetch batches fan out over.  Cached chunks are read-only
    and keyed by content hash; writers always mutate private copies.
    """

    def __init__(self, repo: Repository, snapshot_id: str, *, writable: bool,
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 read_workers: int = 1):
        self.repo = repo
        self.snapshot_id = snapshot_id
        self.writable = writable
        self._doc = repo._read_snapshot(snapshot_id)
        self._manifest_cache: Dict[str, Dict[str, str]] = {}
        self.cache_bytes = int(cache_bytes)
        self.read_workers = max(1, int(read_workers))
        self._own_pool = None
        self._cache_lock = threading.Lock()
        # manifest-object cache: shard/manifest hash -> {chunk key -> ref}
        self._obj_cache: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        # decoded-chunk cache: (ref, chunks, dtype, codec) -> read-only array
        self._chunk_cache: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._chunk_cache_nbytes = 0
        # chunk payloads actually fetched+decoded (cache misses)
        self._fetch_count = 0
        # cache keys a prefetch batch is fetching; the Event is set when
        # the batch lands so demand readers wait instead of re-fetching
        self._inflight: Dict[Tuple, threading.Event] = {}
        # prefetched-but-not-yet-read cache keys: shielded from demand
        # eviction until first use
        self._prefetch_hot: set = set()
        self._prefetch_hits = 0

    # -- caches / concurrency ------------------------------------------
    def reader_pool(self):
        """Executor for multi-chunk read fan-out; None means read serially."""
        if self.read_workers <= 1:
            return None
        with self._cache_lock:  # two first-readers must not both build one
            if self._own_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._own_pool = ThreadPoolExecutor(
                    max_workers=self.read_workers,
                    thread_name_prefix="repro-torch-read",
                )
            return self._own_pool

    def close(self) -> None:
        """Release the session-owned reader pool."""
        with self._cache_lock:
            pool, self._own_pool = self._own_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Release the reader pool; a :class:`Transaction` never commits
        here — an uncommitted ``with`` block abandons its staged state."""
        self.close()

    def cache_stats(self) -> Dict[str, int]:
        """Point-in-time cache/prefetch counters."""
        with self._cache_lock:
            return {
                "chunk_entries": len(self._chunk_cache),
                "chunk_bytes": self._chunk_cache_nbytes,
                "manifest_entries": len(self._obj_cache),
                "chunk_fetches": self._fetch_count,
                "prefetch_hits": self._prefetch_hits,
                "prefetch_hot": len(self._prefetch_hot),
                "prefetch_inflight": len(self._inflight),
            }

    def _obj_cache_put(self, ck: str, obj: Dict[str, Any]) -> None:
        with self._cache_lock:
            self._obj_cache[ck] = obj
            self._obj_cache.move_to_end(ck)
            while len(self._obj_cache) > _OBJ_CACHE_ENTRIES:
                self._obj_cache.popitem(last=False)

    def _cached_obj(self, ck: str, key: str) -> Dict[str, Any]:
        """One content-addressed JSON map (manifest or stat doc), LRU-cached
        under cache key ``ck``."""
        with self._cache_lock:
            obj = self._obj_cache.get(ck)
            if obj is not None:
                self._obj_cache.move_to_end(ck)
                return obj
        obj = _loads(self.repo.store.get(key))
        self._obj_cache_put(ck, obj)
        return obj

    def _manifest_obj(self, mh: str) -> Dict[str, str]:
        """One manifest object (v2 shard or v1 flat map)."""
        return self._cached_obj(mh, f"manifests/{mh}.json")

    def _stats_obj(self, sh: str) -> Dict[str, list]:
        """One stat doc ({chunk key -> [min, max, valid]})."""
        return self._cached_obj(f"stats:{sh}", f"stats/{sh}.json")

    # -- chunk statistics (predicate-pushdown sidecars) -----------------
    def chunk_stats(self, array_path: str, cid) -> Optional[list]:
        """``[min, max, valid_fraction]`` for one chunk, or None when
        unknown (pre-v3 snapshot, raw-blob staged chunk, never written).

        None always means "cannot prune"; callers must read the chunk.
        """
        entry = self._doc.get("stats", {}).get(array_path)
        if entry is None:
            return None
        # stats entries are always shard-aligned lists
        key = _chunk_key(tuple(cid))
        si = _shard_index(key)
        if si >= len(entry) or not entry[si]:
            return None
        return self._stats_obj(entry[si]).get(key)

    # -- structure -------------------------------------------------------
    def list_groups(self) -> List[str]:
        return sorted(self._doc["groups"])

    def list_arrays(self, prefix: str = "") -> List[str]:
        return sorted(p for p in self._doc["arrays"] if p.startswith(prefix))

    def group_attrs(self, path: str) -> Dict[str, Any]:
        try:
            return self._doc["groups"][path]
        except KeyError:
            raise NotFound(f"group {path!r}") from None

    def has_array(self, path: str) -> bool:
        return path in self._doc["arrays"]

    def array(self, path: str) -> Array:
        try:
            meta = ArrayMeta.from_doc(self._doc["arrays"][path])
        except KeyError:
            raise NotFound(f"array {path!r}") from None
        return Array(self, path, meta)

    # -- chunk plumbing (used by zarrlite.Array) -----------------------
    def _manifest(self, array_path: str) -> Dict[str, str]:
        """Full merged chunk map for one array (reads every shard)."""
        if array_path not in self._manifest_cache:
            entry = self._doc["manifests"].get(array_path)
            if entry is None:
                merged: Dict[str, str] = {}
            elif isinstance(entry, str):  # v1: one flat map
                merged = dict(self._manifest_obj(entry))
            else:  # v2: merge shards (disjoint by construction)
                merged = {}
                for sh in entry:
                    if sh:
                        merged.update(self._manifest_obj(sh))
            self._manifest_cache[array_path] = merged
        return self._manifest_cache[array_path]

    def chunk_ref(self, array_path: str, cid: Sequence[int]) -> Optional[str]:
        key = _chunk_key(tuple(cid))
        entry = self._doc["manifests"].get(array_path)
        if entry is None:
            return None
        if isinstance(entry, str):  # v1
            return self._manifest_obj(entry).get(key)
        si = _shard_index(key)
        if si >= len(entry) or not entry[si]:
            return None
        return self._manifest_obj(entry[si]).get(key)

    def get_blob(self, ref: str) -> bytes:
        """Raw chunk payload for one content hash (single GET)."""
        return self.repo.store.get(f"chunks/{ref}")

    def get_blobs(self, refs: Sequence[str]) -> Dict[str, bytes]:
        """Raw chunk payloads for several content hashes in one batch."""
        uniq = list(dict.fromkeys(refs))
        got = self.repo.store.get_many([f"chunks/{r}" for r in uniq])
        return {r: got[f"chunks/{r}"] for r in uniq}

    def _prefetch_manifests(self, array_paths: Sequence[str], *,
                            stats: bool = False) -> int:
        """Warm the manifest-object cache for ``array_paths`` in one
        batched fetch; returns the number of objects fetched.  With
        ``stats=True`` the arrays' stat sidecars ride in the same batch,
        so a planner about to prune pays no extra round trips."""
        wanted: "OrderedDict[str, str]" = OrderedDict()  # cache key -> obj key
        for path in dict.fromkeys(array_paths):
            entry = self._doc["manifests"].get(path)
            if isinstance(entry, str):  # v1: one flat map
                wanted[entry] = f"manifests/{entry}.json"
            elif entry:
                for sh in entry:
                    if sh:
                        wanted[sh] = f"manifests/{sh}.json"
            if stats:
                for sh in self._doc.get("stats", {}).get(path) or []:
                    if sh:
                        wanted[f"stats:{sh}"] = f"stats/{sh}.json"
        with self._cache_lock:
            missing = [(ck, ok) for ck, ok in wanted.items()
                       if ck not in self._obj_cache]
        if not missing:
            return 0
        got = self.repo.store.get_many([ok for _, ok in missing])
        for ck, ok in missing:
            self._obj_cache_put(ck, _loads(got[ok]))
        return len(missing)

    @staticmethod
    def _selection_slices(meta: ArrayMeta, selection) -> List[slice]:
        """Selection normalized to per-axis unit-step slices (ints become
        length-1 slices)."""
        sels = normalize_selection(selection, len(meta.shape))
        slices = []
        for ax, s in enumerate(sels):
            if isinstance(s, slice):
                slices.append(s)
            else:
                i = int(s)
                if i < 0:
                    i += meta.shape[ax]
                slices.append(slice(i, i + 1))
        return slices

    def prefetch(self, items, *, wait: bool = True) -> PrefetchReport:
        """Fetch the chunks a set of upcoming reads will need, batched per
        manifest shard into :data:`PREFETCH_BATCH_KEYS`-sized GET groups.

        ``items`` holds array paths (whole array), ``(array_path,
        selection)`` pairs, or ``(array_path, [cid, ...])`` pairs with an
        explicit list of chunk ids.  Chunks whose decoded size would
        overflow ``cache_bytes`` are *deferred* to demand reads.  Writable
        sessions skip prefetching (staged chunks shadow committed ones).
        With ``wait=False`` the batches run on the reader pool in the
        background; demand reads wait on in-flight chunks.
        """
        report = PrefetchReport()
        if self.writable:
            return report
        norm: List[Tuple[str, Any]] = []
        for item in items:
            if isinstance(item, str):
                norm.append((item, None))
            else:
                path, sel = item
                norm.append((path, sel))
        if not norm:
            return report
        self._prefetch_manifests([p for p, _ in norm])
        # resolve the plan: unique cache keys, grouped by manifest shard
        plan: "OrderedDict[Tuple, Tuple[str, int]]" = OrderedDict()
        est_bytes: Dict[Tuple, int] = {}
        for path, sel in norm:
            doc = self._doc["arrays"].get(path)
            if doc is None:
                continue
            meta = ArrayMeta.from_doc(doc)
            grid = meta.grid
            if sel is None:
                cids = list(grid.chunk_ids())
            elif isinstance(sel, list):  # explicit chunk-id list
                cids = [tuple(int(c) for c in cid) for cid in sel]
            else:
                cids = list(grid.chunks_for_selection(
                    self._selection_slices(meta, sel)))
            est = int(np.prod(meta.chunks)) * np.dtype(meta.dtype).itemsize
            for cid in cids:
                ref = self.chunk_ref(path, cid)
                if ref is None:
                    continue
                key = (ref, tuple(meta.chunks), meta.dtype, meta.codec)
                if key in plan:
                    continue
                plan[key] = (path, _shard_index(_chunk_key(tuple(cid))))
                est_bytes[key] = est
        report.planned = len(plan)
        if not plan:
            return report
        # admission + in-flight marking happen atomically, before any
        # batch is submitted: a racing demand read either sees the cached
        # chunk or an in-flight marker it can wait on
        groups: "OrderedDict[Tuple[str, int], List[Tuple]]" = OrderedDict()
        with self._cache_lock:
            projected = self._chunk_cache_nbytes
            for key, group in plan.items():
                if key in self._chunk_cache:
                    report.cached += 1
                    continue
                if key in self._inflight:
                    report.inflight += 1
                    continue
                if projected + est_bytes[key] > self.cache_bytes:
                    report.deferred += 1
                    continue
                projected += est_bytes[key]
                self._inflight[key] = threading.Event()
                groups.setdefault(group, []).append(key)
                report.scheduled += 1
        batches: List[List[Tuple]] = []
        for keys in groups.values():
            for i in range(0, len(keys), PREFETCH_BATCH_KEYS):
                batches.append(keys[i:i + PREFETCH_BATCH_KEYS])
        report.batches = len(batches)
        pool = self.reader_pool()
        if pool is None:
            for batch in batches:
                self._fetch_group(batch)
        else:
            for batch in batches:
                report._jobs.append(pool.submit(self._fetch_group, batch))
            if wait:
                report.wait()
        return report

    def _fetch_group(self, keys: Sequence[Tuple]) -> None:
        """Fetch one batch, decode, admit each chunk, then release the
        in-flight markers (always — waiters must never hang)."""
        try:
            blobs = self.get_blobs([k[0] for k in keys])
            for key in keys:
                chunk = decode_chunk(blobs[key[0]], key[1], key[2], key[3],
                                     writable=False)
                self._admit_prefetched(key, chunk)
        finally:
            with self._cache_lock:
                for key in keys:
                    ev = self._inflight.pop(key, None)
                    if ev is not None:
                        ev.set()

    def _admit_prefetched(self, key: Tuple, chunk) -> None:
        """Insert a prefetched chunk and mark it *hot*, or drop it if the
        cache is full — speculation never evicts resident data."""
        with self._cache_lock:
            self._fetch_count += 1
            if key in self._chunk_cache:
                return
            if self._chunk_cache_nbytes + chunk.nbytes > self.cache_bytes:
                return
            self._chunk_cache[key] = chunk
            self._chunk_cache_nbytes += chunk.nbytes
            self._prefetch_hot.add(key)

    def _cache_lookup(self, key: Tuple) -> Optional[Any]:
        """Locked chunk-cache probe; the first demand hit on a prefetched
        chunk consumes its *hot* marker and counts a prefetch hit."""
        with self._cache_lock:
            hit = self._chunk_cache.get(key)
            if hit is not None:
                self._chunk_cache.move_to_end(key)
                if key in self._prefetch_hot:
                    self._prefetch_hot.discard(key)
                    self._prefetch_hits += 1
            return hit

    def decoded_chunk(self, array_path: str, cid,
                      meta: ArrayMeta) -> Optional[Any]:
        """Decoded chunk at full padded shape, **read-only**, LRU-cached.

        Returns None when the chunk was never written (caller substitutes
        the fill value).  A miss on a chunk an active prefetch batch is
        fetching waits for that batch (with a timed fallback to a direct
        fetch).
        """
        ref = self.chunk_ref(array_path, cid)
        if ref is None:
            return None
        key = (ref, tuple(meta.chunks), meta.dtype, meta.codec)
        hit = self._cache_lookup(key)
        if hit is not None:
            return hit
        with self._cache_lock:
            ev = self._inflight.get(key)
        if ev is not None:
            ev.wait(_INFLIGHT_WAIT_S)
            hit = self._cache_lookup(key)
            if hit is not None:
                return hit
            # batch failed, timed out, or admission dropped the chunk:
            # fall through to a direct (possibly duplicate) fetch
        blob = self.get_blob(ref)
        chunk = decode_chunk(blob, tuple(meta.chunks), meta.dtype,
                             meta.codec, writable=False)
        with self._cache_lock:
            self._fetch_count += 1
            winner = self._chunk_cache.get(key)
            if winner is not None:  # lost a decode race: share the winner
                return winner
            self._chunk_cache[key] = chunk
            self._chunk_cache_nbytes += chunk.nbytes
            while (self._chunk_cache_nbytes > self.cache_bytes
                   and self._chunk_cache):
                victim = None
                for k in self._chunk_cache:  # LRU order, skip hot entries
                    if k not in self._prefetch_hot:
                        victim = k
                        break
                if victim is None:  # everything is hot: evict LRU anyway
                    victim = next(iter(self._chunk_cache))
                    self._prefetch_hot.discard(victim)
                old = self._chunk_cache.pop(victim)
                self._chunk_cache_nbytes -= old.nbytes
        return chunk

    def staged_chunk_array(self, array_path: str, cid) -> Optional[Any]:
        """Decoded chunk staged in this session, if any (None when pinned)."""
        return None

    def stage_chunk_array(self, array_path: str, cid, chunk) -> None:
        raise PermissionError("read-only session")


class Transaction(Session):
    """Writable session: stages changes, commits atomically."""

    def __init__(self, repo: Repository, branch: str, head: str,
                 **session_kw):
        super().__init__(repo, head, writable=True, **session_kw)
        self.branch = branch
        self._staged_chunks: Dict[str, Dict[str, str]] = {}  # path -> key -> hash
        # decoded chunks not yet encoded: path -> key -> ndarray.  Encoding
        # is deferred to commit so N appends into one chunk pay the codec
        # once, and the encodes can fan out over `encode_workers` threads
        # (zlib/lzma/zstd all release the GIL).
        self._staged_arrays: Dict[str, Dict[str, Any]] = {}
        # stat triples for staged chunks: path -> key -> [min, max, valid]
        self._staged_stats: Dict[str, Dict[str, list]] = {}
        self._touched: set = set()
        self._closed = False
        self.encode_workers = 1

    # -- schema edits ------------------------------------------------------
    def create_group(self, path: str, attrs: Optional[Dict[str, Any]] = None):
        parts = path.strip("/").split("/") if path.strip("/") else []
        # create intermediate groups implicitly; only *new* groups (or groups
        # whose attrs change) count as touched
        for i in range(len(parts) + 1):
            p = "/".join(parts[:i])
            if p not in self._doc["groups"]:
                self._doc["groups"][p] = {}
                self._touched.add(p)
        if attrs:
            self._doc["groups"][path.strip("/")].update(attrs)
            self._touched.add(path.strip("/"))

    def update_group_attrs(self, path: str, attrs: Dict[str, Any]) -> None:
        self.create_group(path)
        self._doc["groups"][path.strip("/")].update(attrs)
        self._touched.add(path.strip("/"))

    def create_array(
        self,
        path: str,
        *,
        shape: Sequence[int],
        dtype: str,
        chunks: Sequence[int],
        attrs: Optional[Dict[str, Any]] = None,
        fill_value: float = float("nan"),
        codec: Optional[str] = None,
    ) -> Array:
        path = path.strip("/")
        parent = path.rsplit("/", 1)[0] if "/" in path else ""
        self.create_group(parent)
        codec = get_codec(codec).name  # resolve default + fail fast on unknown
        if np.isnan(fill_value) and not np.issubdtype(np.dtype(dtype),
                                                      np.floating):
            fill_value = 0.0
        meta = ArrayMeta(tuple(shape), dtype, tuple(chunks), dict(attrs or {}),
                         fill_value, codec)
        self._doc["arrays"][path] = meta.to_doc()
        self._touched.add(path)
        return Array(self, path, meta)

    def resize_array(self, path: str, new_shape: Sequence[int]) -> Array:
        """Grow an array (e.g. append along time). Chunk grid is preserved."""
        doc = self._doc["arrays"].get(path)
        if doc is None:
            raise NotFound(f"array {path!r}")
        old = tuple(doc["shape"])
        new = tuple(new_shape)
        if len(old) != len(new) or any(n < o for n, o in zip(new, old)):
            raise ValueError(f"resize must grow: {old} -> {new}")
        doc["shape"] = list(new)
        self._touched.add(path)
        return self.array(path)

    def delete_array(self, path: str) -> None:
        """Drop an array (metadata, manifest, stat sidecar and anything
        staged for it) from this transaction's snapshot."""
        self._doc["arrays"].pop(path, None)
        self._doc["manifests"].pop(path, None)
        self._doc.get("stats", {}).pop(path, None)
        self._staged_chunks.pop(path, None)
        self._staged_arrays.pop(path, None)
        self._staged_stats.pop(path, None)
        self._manifest_cache.pop(path, None)
        self._touched.add(path)

    # -- chunk staging -------------------------------------------------
    def stage_chunk_array(self, array_path: str, cid, chunk) -> None:
        """Stage one *decoded* chunk; encoding is deferred to commit.

        Re-staging the same chunk object is idempotent, so in-place
        read-modify-write cycles (the append hot path) never re-encode.
        """
        self._staged_arrays.setdefault(array_path, {})[
            _chunk_key(tuple(cid))
        ] = chunk
        self._touched.add(array_path)

    def staged_chunk_array(self, array_path: str, cid) -> Optional[Any]:
        return self._staged_arrays.get(array_path, {}).get(
            _chunk_key(tuple(cid))
        )

    def chunk_ref(self, array_path: str, cid: Sequence[int]) -> Optional[str]:
        staged = self._staged_chunks.get(array_path, {})
        key = _chunk_key(tuple(cid))
        if key in staged:
            return staged[key]
        return super().chunk_ref(array_path, cid)

    # -- commit ----------------------------------------------------------
    def commit(self, message: str) -> str:
        """Encode staged chunks, write the snapshot, flip the branch ref.

        Raises :class:`ConflictError` when another writer moved the branch
        since this transaction opened (no rebase in this package yet).
        """
        if self._closed:
            raise RuntimeError("transaction already committed")
        # encode + persist staged decoded chunks exactly once, before the
        # CAS (write-ahead: payloads land before the ref can flip)
        self._flush_staged_arrays()
        sid = self.repo._write_snapshot(self._build_snapshot_doc(message))
        if not self.repo.store.compare_and_swap(
            self.repo._ref_key(self.branch),
            _dumps({"snapshot": self.snapshot_id}),
            _dumps({"snapshot": sid}),
        ):
            raise ConflictError(
                f"branch {self.branch!r} moved since this transaction "
                f"opened at {self.snapshot_id}; retry on a fresh session"
            )
        self._closed = True
        return sid

    # -- internals -------------------------------------------------------
    def _flush_staged_arrays(self) -> None:
        jobs = []
        for path, chunks in self._staged_arrays.items():
            codec = ArrayMeta.from_doc(self._doc["arrays"][path]).codec
            for key, arr in chunks.items():
                jobs.append((path, key, arr, codec))

        def encode(job):
            path, key, arr, codec = job
            stats = chunk_stats_summary(arr)
            blob = encode_chunk(arr, codec)
            ref = content_hash(blob)
            # refs are unique content addresses and put-if-not-exists is
            # idempotent, so concurrent writers are safe
            self.repo.store.put(f"chunks/{ref}", blob, if_not_exists=True)
            return path, key, ref, stats

        if self.encode_workers > 1 and len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self.encode_workers) as pool:
                encoded = list(pool.map(encode, jobs))
        else:
            encoded = [encode(j) for j in jobs]
        for path, key, ref, stats in encoded:
            self._staged_chunks.setdefault(path, {})[key] = ref
            self._staged_stats.setdefault(path, {})[key] = stats
        self._staged_arrays.clear()

    def _put_manifest_obj(self, obj: Dict[str, str]) -> str:
        """Persist one content-addressed manifest object; seed the cache."""
        blob = _dumps(obj)
        mh = content_hash(blob)
        self.repo.store.put(f"manifests/{mh}.json", blob, if_not_exists=True)
        self._obj_cache_put(mh, obj)
        return mh

    def _sharded_entry(self, array_path: str,
                       staged: Dict[str, str]) -> List[Optional[str]]:
        """Merge staged chunk refs into the array's v2 shard list, writing
        only the shards that received new keys (plus a one-time v1→v2
        split when the array still carries a flat v1 manifest)."""
        entry = self._doc["manifests"].get(array_path)
        if isinstance(entry, list):
            shards: List[Optional[str]] = list(entry)
        elif isinstance(entry, str):
            split: Dict[int, Dict[str, str]] = {}
            for key, ref in self._manifest_obj(entry).items():
                split.setdefault(_shard_index(key), {})[key] = ref
            shards = []
            for si, m in sorted(split.items()):
                while len(shards) <= si:
                    shards.append(None)
                shards[si] = self._put_manifest_obj(m)
        else:
            shards = []
        by_shard: Dict[int, Dict[str, str]] = {}
        for key, ref in staged.items():
            by_shard.setdefault(_shard_index(key), {})[key] = ref
        for si, add in sorted(by_shard.items()):
            while len(shards) <= si:
                shards.append(None)
            base = dict(self._manifest_obj(shards[si])) if shards[si] else {}
            base.update(add)
            shards[si] = self._put_manifest_obj(base)
        return shards

    def _put_stats_obj(self, obj: Dict[str, list]) -> str:
        """Persist one content-addressed stat doc; seed the shared cache."""
        blob = _dumps(obj)
        sh = content_hash(blob)
        self.repo.store.put(f"stats/{sh}.json", blob, if_not_exists=True)
        self._obj_cache_put(f"stats:{sh}", obj)
        return sh

    def _backfill_stats(self, array_path: str,
                        skip_keys) -> Dict[str, list]:
        """Stats for every pre-existing chunk of an array with no sidecar:
        the lazy v1/v2→v3 migration the first write into such an array
        pays (the keys this commit overwrites are skipped)."""
        meta = ArrayMeta.from_doc(self._doc["arrays"][array_path])
        out: Dict[str, list] = {}
        for key, ref in self._manifest(array_path).items():
            if key in skip_keys:
                continue
            chunk = decode_chunk(self.get_blob(ref), tuple(meta.chunks),
                                 meta.dtype, meta.codec, writable=False)
            out[key] = chunk_stats_summary(chunk)
        return out

    def _stats_entry(self, array_path: str,
                     staged: Dict[str, list]) -> List[Optional[str]]:
        """Merge staged chunk stats into the array's sharded stats entry,
        rewriting only the shards whose keys changed."""
        entry = self._doc.get("stats", {}).get(array_path)
        by_shard: Dict[int, Dict[str, list]] = {}
        if isinstance(entry, list):
            shards: List[Optional[str]] = list(entry)
        else:
            shards = []
            if self._doc["manifests"].get(array_path) is not None:
                # no sidecar yet but the array has committed chunks:
                # migrate (backfill) the whole array on this first write
                for key, st in self._backfill_stats(array_path,
                                                    set(staged)).items():
                    by_shard.setdefault(_shard_index(key), {})[key] = st
        for key, st in staged.items():
            by_shard.setdefault(_shard_index(key), {})[key] = st
        for si, add in sorted(by_shard.items()):
            while len(shards) <= si:
                shards.append(None)
            base = dict(self._stats_obj(shards[si])) if shards[si] else {}
            base.update(add)
            shards[si] = self._put_stats_obj(base) if base else None
        return shards

    def _build_snapshot_doc(self, message: str) -> Dict[str, Any]:
        manifests = dict(self._doc["manifests"])
        stats = dict(self._doc.get("stats", {}))
        for array_path, staged in self._staged_chunks.items():
            manifests[array_path] = self._sharded_entry(array_path, staged)
            sstats = self._staged_stats.get(array_path, {})
            stats[array_path] = self._stats_entry(
                array_path, {key: sstats[key] for key in staged}
            )
        doc = {
            "parent": self.snapshot_id,
            "message": message,
            # provenance only: excluded from the id hash
            "written_at": time.time(),
            "touched": sorted(self._touched),
            "groups": self._doc["groups"],
            "arrays": self._doc["arrays"],
            "manifests": manifests,
        }
        if stats:
            # omitted when empty so archives holding no chunk data keep
            # the snapshot documents (and ids) of older formats
            doc["stats"] = stats
        return doc
