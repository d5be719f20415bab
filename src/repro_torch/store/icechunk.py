"""Transactional, versioned storage engine over the object store.

The Icechunk design the archive relies on, the reference package's store
kept as this package's own copy with the snapshot, manifest and
stat-sidecar formats unchanged, so the same operations give the same
snapshot ids and either package reads the other's archives.  It runs
against any :class:`~repro_torch.store.object_store.Backend`:

* **Immutable, content-addressed chunks** — every chunk payload is stored
  once under its sha256 address.  Identical data dedups; nothing is ever
  overwritten in place.
* **Sharded per-array manifests** — each array's ``chunk id → content
  hash`` map is split into content-addressed *shards* keyed by chunk-grid
  region along the leading (time) axis, so an append re-writes one small
  shard, not the whole manifest: metadata bytes per commit stay
  O(changed data), independent of archive length.  Snapshot documents
  reference ``{array → [shard hashes]}`` (format v2); the single-manifest
  v1 format (``{array → manifest hash}``) written by older repositories
  is read transparently and migrated per-array on first write.
* **Chunk-statistics sidecars** — commits additionally write per-chunk
  ``[min, max, valid_fraction]`` triples into content-addressed *stat
  docs* referenced from the snapshot alongside the manifest shards
  (format v3).  The catalog query planner (:mod:`repro_torch.catalog.query`)
  uses them for predicate pushdown: chunks that cannot contain a match
  are never fetched or decoded.  v1/v2 snapshots read back unchanged
  (no stats → planners fall back to reading everything) and an array
  gains stats for all of its existing chunks on the first write that
  touches it, mirroring the v1→v2 manifest migration.
* **Cached, concurrent reads** — every session carries an LRU decoded-
  chunk cache plus a manifest-shard cache, and multi-chunk selections can
  fan out over a thread pool (object-store ``get`` and codec decode both
  release the GIL), so QVP/time-series workloads issue parallel reads.
* **Snapshots** — a snapshot document references group/array metadata and
  manifest hashes, plus its parent snapshot.  Snapshot ids are content
  hashes of the canonical document (wall-clock ``written_at`` excluded):
  the same data produces the same id.
* **Atomic commits** — a branch ref flips from parent to child via
  compare-and-swap.  Staged chunks written before the flip are unreachable
  until the flip succeeds (write-ahead behaviour); a crash mid-transaction
  leaves the previous snapshot fully intact (atomicity) and at most some
  orphaned chunks for GC.
* **Conflict detection & rebase** — a commit racing another writer fails
  its CAS, reloads the new head, and either rebases (disjoint array paths)
  or raises :class:`ConflictError`.
* **Branches, tags, history, rollback, time-travel reads.**
* **Background compaction** — :meth:`Repository.compact` (see
  :mod:`repro_torch.store.compaction`) rewrites append-fragmented chunks into
  analysis-optimized layouts through the same commit/CAS path, with
  bitwise-identical reads; ``gc(keep_history=False)`` expires history so
  the superseded chunks become sweepable.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


from .chunks import (chunk_stats_summary, content_hash, decode_chunk,
                     encode_chunk, normalize_selection)
from .codecs import get_codec, json_dumps, json_loads
from .object_store import ObjectStore
from .zarrlite import Array, ArrayMeta, _chunk_key


class ConflictError(RuntimeError):
    """Concurrent commit touched the same arrays and cannot be rebased."""


class NotFound(KeyError):
    """Missing key/array/snapshot lookup (a ``KeyError``)."""
    pass


# canonical JSON (stdlib, sorted keys, compact) — the hashed byte encoding
_dumps = json_dumps
_loads = json_loads

# fields excluded from the snapshot's content address: wall-clock metadata
# must not change the id, or "same data -> same id" (and the determinism of
# replayed/parallel ingests) breaks.
_VOLATILE_SNAPSHOT_FIELDS = ("written_at",)


_EMPTY_SNAPSHOT_ID = "root"

# -- manifest format -------------------------------------------------------
# v1: snapshot["manifests"][path] is the content hash (str) of one flat
#     {chunk key -> chunk hash} document covering the whole array.
# v2: snapshot["manifests"][path] is a list of shard hashes (or None for
#     all-empty shards); shard i holds the keys of chunks whose leading
#     (time) grid coordinate falls in [i*span, (i+1)*span).  Shard
#     membership is a pure function of the chunk id, so an append rewrites
#     exactly the shards its chunks land in.
# v3: v2 plus chunk-statistics sidecars: snapshot["stats"][path] is a list
#     of stat-doc hashes aligned with the manifest shard list; stat doc =
#     {chunk key -> [min, max, valid_fraction]} under stats/<hash>.json.
#     The "stats" key is *optional* — v1/v2 snapshots (and v3 snapshots of
#     repos holding no chunk data) simply omit it, so older snapshots read
#     back byte-identical and stat lookups degrade to "unknown".
MANIFEST_FORMAT = 3
# time-chunks per manifest shard; a *v2 format constant* — changing it
# changes which shard a chunk key belongs to, i.e. a new format version.
MANIFEST_SHARD_CHUNKS = 8

# objects younger than this survive gc even when unreferenced: staged
# chunks/manifests/snapshots land *before* the commit CAS by design
# (write-ahead), so a concurrent gc must not sweep an in-flight commit.
GC_GRACE_SECONDS = 3600.0

# decoded-chunk LRU budget per session (bytes)
DEFAULT_CACHE_BYTES = 128 << 20
# manifest-shard/manifest-object LRU entries per session
_OBJ_CACHE_ENTRIES = 1024
# chunk payloads per coalesced GET batch: per-shard groups are packed into
# batches of at most this many keys, so one slow giant batch never
# serializes the whole prefetch plan behind a single round trip
PREFETCH_BATCH_KEYS = 16
# how long a demand read waits for an in-flight prefetch of the same chunk
# before falling back to a direct fetch (a safety net, not a code path the
# healthy pipeline ever takes)
_INFLIGHT_WAIT_S = 15.0


@dataclass
class PrefetchReport:
    """Outcome of one :meth:`Session.prefetch` plan.

    ``planned`` counts the distinct committed chunk payloads the plan
    covered; each is then ``cached`` (already resident), ``inflight``
    (another plan is fetching it), ``deferred`` (the byte-budget
    admission policy left it to demand paging), or ``scheduled`` into
    one of ``batches`` coalesced GET batches.  All counts are
    deterministic for a given session state — they are what the remote
    read tests and benchmarks assert on.
    """

    planned: int = 0
    scheduled: int = 0
    cached: int = 0
    inflight: int = 0
    deferred: int = 0
    batches: int = 0
    _jobs: List[Any] = field(default_factory=list, repr=False)

    def wait(self) -> "PrefetchReport":
        """Block until every scheduled fetch batch has landed.

        Re-raises the first batch failure; an unawaited report's
        failures are absorbed by the demand-read fallback instead.
        """
        jobs, self._jobs = self._jobs, []
        for job in jobs:
            job.result()
        return self


def _shard_index(chunk_key: str) -> int:
    """Manifest shard holding ``chunk_key`` ("c<i0>/<i1>/...")."""
    first = chunk_key[1:].split("/", 1)[0]
    return int(first) // MANIFEST_SHARD_CHUNKS


def _entry_shard_hashes(entry) -> List[str]:
    """All manifest-object hashes referenced by a snapshot manifest entry
    (v1 str or v2 list)."""
    if entry is None:
        return []
    if isinstance(entry, str):
        return [entry]
    return [h for h in entry if h]


@dataclass
class CommitInfo:
    """One commit's metadata: snapshot id, parent, message."""
    snapshot_id: str
    parent_id: Optional[str]
    message: str
    written_at: float
    touched: List[str]


class Repository:
    """A versioned archive: the durable half of a Radar DataTree."""

    def __init__(self, store: ObjectStore, *,
                 manifest_format: int = MANIFEST_FORMAT):
        if manifest_format not in (1, 2, 3):
            raise ValueError(f"unknown manifest format {manifest_format!r}")
        self.store = store
        # the format this repository *writes*; all formats are always read
        self.manifest_format = manifest_format

    @property
    def writes_stats(self) -> bool:
        """Whether commits emit chunk-statistics sidecars (format >= 3)."""
        return self.manifest_format >= 3

    # -- creation ------------------------------------------------------
    @staticmethod
    def _coerce_store(store_or_path):
        """Accept any :class:`~repro_torch.store.object_store.Backend` as-is;
        strings/paths open a local :class:`ObjectStore` rooted there."""
        if isinstance(store_or_path, (str, os.PathLike)):
            return ObjectStore(store_or_path)
        return store_or_path

    @classmethod
    def create(cls, store_or_path, *, branch: str = "main",
               manifest_format: int = MANIFEST_FORMAT) -> "Repository":
        store = cls._coerce_store(store_or_path)
        repo = cls(store, manifest_format=manifest_format)
        empty = {
            "parent": None,
            "message": "repository created",
            "groups": {"": {}},
            "arrays": {},
            "manifests": {},
        }
        sid = repo._write_snapshot(empty)
        if not store.compare_and_swap(
            repo._ref_key(branch), None, _dumps({"snapshot": sid})
        ):
            raise RuntimeError(f"branch {branch!r} already exists")
        return repo

    @classmethod
    def open(cls, store_or_path, *,
             manifest_format: int = MANIFEST_FORMAT) -> "Repository":
        return cls(cls._coerce_store(store_or_path),
                   manifest_format=manifest_format)

    # -- refs ------------------------------------------------------------
    @staticmethod
    def _ref_key(branch: str) -> str:
        return f"refs/branch.{branch}.json"

    @staticmethod
    def _tag_key(tag: str) -> str:
        return f"refs/tag.{tag}.json"

    def branch_head(self, branch: str = "main") -> str:
        try:
            return _loads(self.store.get(self._ref_key(branch)))["snapshot"]
        except KeyError:
            raise NotFound(f"branch {branch!r}") from None

    def branches(self) -> List[str]:
        out = []
        for key in self.store.list("refs/"):
            name = key.rsplit("/", 1)[-1]
            # ignore transient CAS .lock files a racing commit may hold
            if name.startswith("branch.") and name.endswith(".json"):
                out.append(name[len("branch."):-len(".json")])
        return sorted(out)

    def create_branch(self, name: str, snapshot_id: str) -> None:
        if not self.store.compare_and_swap(
            self._ref_key(name), None, _dumps({"snapshot": snapshot_id})
        ):
            raise RuntimeError(f"branch {name!r} already exists")

    def tag(self, name: str, snapshot_id: str) -> None:
        if not self.store.compare_and_swap(
            self._tag_key(name), None, _dumps({"snapshot": snapshot_id})
        ):
            raise RuntimeError(f"tag {name!r} already exists")

    def tag_head(self, name: str) -> str:
        try:
            return _loads(self.store.get(self._tag_key(name)))["snapshot"]
        except KeyError:
            raise NotFound(f"tag {name!r}") from None

    def rollback(self, branch: str, snapshot_id: str) -> None:
        """Reset a branch head to an earlier snapshot (paper §5.4)."""
        current = self.branch_head(branch)
        # verify target is an ancestor (or any valid snapshot) — must exist:
        self._read_snapshot(snapshot_id)
        ok = self.store.compare_and_swap(
            self._ref_key(branch),
            _dumps({"snapshot": current}),
            _dumps({"snapshot": snapshot_id}),
        )
        if not ok:
            raise ConflictError("branch moved during rollback")

    # -- snapshots ---------------------------------------------------------
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

    def history(self, branch: str = "main") -> Iterator[CommitInfo]:
        """Walk the branch's commit chain, newest first.

        A parent expired by ``gc(keep_history=False)`` ends the walk —
        the surviving prefix is still valid history."""
        sid: Optional[str] = self.branch_head(branch)
        while sid is not None:
            try:
                doc = self._read_snapshot(sid)
            except NotFound:
                return
            yield CommitInfo(
                snapshot_id=sid,
                parent_id=doc.get("parent"),
                message=doc.get("message", ""),
                written_at=doc.get("written_at", 0.0),
                touched=sorted(doc.get("touched", [])),
            )
            sid = doc.get("parent")

    # -- sessions ----------------------------------------------------------
    def _open_branch_with_hint(
        self, branch: str, hint: str
    ) -> Tuple[str, Optional[Dict[str, Any]]]:
        """Resolve a branch head speculatively: fetch the ref *and* the
        hinted snapshot document in one coalesced round trip.

        When the hint still names the head (the common case — catalogs
        refresh their recorded head on every commit), opening a session
        costs one GET instead of two serial ones.  A stale or vanished
        hint degrades to the plain two-step open, never to an error.
        """
        ref_key = self._ref_key(branch)
        snap_key = f"snapshots/{hint}.json"
        try:
            got = self.store.get_many([ref_key, snap_key])
        except KeyError:
            # hinted snapshot expired (gc) or branch missing: serial path,
            # which reports the missing branch with the usual NotFound
            return self.branch_head(branch), None
        sid = _loads(got[ref_key])["snapshot"]
        if sid == hint:
            return sid, _loads(got[snap_key])
        return sid, None  # branch moved past the hint; re-fetch the head doc

    def readonly_session(
        self, *, branch: str = "main", snapshot_id: Optional[str] = None,
        tag: Optional[str] = None,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        read_workers: int = 1,
        snapshot_hint: Optional[str] = None,
    ) -> "Session":
        doc: Optional[Dict[str, Any]] = None
        if snapshot_id is None:
            if tag:
                snapshot_id = self.tag_head(tag)
            elif snapshot_hint:
                snapshot_id, doc = self._open_branch_with_hint(
                    branch, snapshot_hint)
            else:
                snapshot_id = self.branch_head(branch)
        return Session(self, snapshot_id, writable=False,
                       cache_bytes=cache_bytes, read_workers=read_workers,
                       doc=doc)

    def writable_session(self, branch: str = "main",
                         **session_kw) -> "Transaction":
        head = self.branch_head(branch)
        return Transaction(self, branch, head, **session_kw)

    # -- maintenance: compaction ---------------------------------------
    def compact(self, profile="timeseries", **kw):
        """Rewrite fragmented per-append chunks into analysis-optimized
        ones — see :func:`repro_torch.store.compaction.compact` for profiles,
        retry semantics and the report it returns."""
        from .compaction import compact as _compact

        return _compact(self, profile, **kw)

    # -- garbage collection --------------------------------------------
    def gc(self, *, grace_seconds: float = GC_GRACE_SECONDS,
           keep_history: bool = True) -> Dict[str, int]:
        """Mark-and-sweep unreferenced chunks/manifests/snapshots.

        Unreferenced objects younger than ``grace_seconds`` are kept: a
        transaction persists chunk payloads, manifest shards and its
        snapshot document *before* the branch-ref CAS (write-ahead), so an
        object can legitimately be unreferenced for the duration of an
        in-flight commit.  ``grace_seconds=0`` restores the aggressive
        sweep (only safe when no writer can be mid-commit).

        ``keep_history=False`` expires history: only the snapshots that
        branch/tag refs point at directly stay live, so chunks a
        compaction superseded (referenced *only* by ancestor snapshots)
        become sweepable.  Time-travel reads of expired snapshots stop
        working; :meth:`history` ends at the expiry horizon.  Tag a
        snapshot first to keep it (and everything it references) alive.
        """
        now = time.time()

        def expendable(key: str) -> bool:
            try:
                return now - self.store.mtime(key) >= grace_seconds
            except KeyError:  # raced with another delete
                return False

        live_snaps: set = set()
        stack = []
        for key in self.store.list("refs/"):
            if not key.endswith(".json"):
                continue  # transient CAS .lock file of an in-flight commit
            try:
                stack.append(_loads(self.store.get(key))["snapshot"])
            except KeyError:  # ref deleted between list and get
                continue
        while stack:
            sid = stack.pop()
            if sid in live_snaps:
                continue
            live_snaps.add(sid)
            if not keep_history:
                continue  # roots only: ancestors are expired, not live
            try:
                parent = self._read_snapshot(sid).get("parent")
            except NotFound:  # already expired by an earlier sweep
                continue
            if parent:
                stack.append(parent)
        live_manifests: set = set()
        live_stats: set = set()
        live_chunks: set = set()
        for sid in live_snaps:
            try:
                doc = self._read_snapshot(sid)
            except NotFound:  # expired ancestor encountered mid-walk
                continue
            for entry in doc["manifests"].values():
                live_manifests.update(_entry_shard_hashes(entry))
            for entry in doc.get("stats", {}).values():
                live_stats.update(_entry_shard_hashes(entry))
        for mh in live_manifests:
            manifest = _loads(self.store.get(f"manifests/{mh}.json"))
            live_chunks.update(manifest.values())
        removed = {"snapshots": 0, "manifests": 0, "stats": 0, "chunks": 0}
        for key in list(self.store.list("snapshots/")):
            if (key.rsplit("/", 1)[-1][:-len(".json")] not in live_snaps
                    and expendable(key)):
                self.store.delete(key)
                removed["snapshots"] += 1
        for key in list(self.store.list("manifests/")):
            if (key.rsplit("/", 1)[-1][:-len(".json")] not in live_manifests
                    and expendable(key)):
                self.store.delete(key)
                removed["manifests"] += 1
        for key in list(self.store.list("stats/")):
            if (key.rsplit("/", 1)[-1][:-len(".json")] not in live_stats
                    and expendable(key)):
                self.store.delete(key)
                removed["stats"] += 1
        for key in list(self.store.list("chunks/")):
            if (key.rsplit("/", 1)[-1] not in live_chunks
                    and expendable(key)):
                self.store.delete(key)
                removed["chunks"] += 1
        return removed


class Session:
    """Read view pinned to one snapshot (snapshot isolation).

    Carries two LRU caches shared by all arrays it opens — decoded chunks
    (budgeted in bytes) and manifest shards (budgeted in entries) — plus an
    optional reader thread pool (``read_workers``) that
    :meth:`~repro_torch.store.zarrlite.Array.__getitem__` fans multi-chunk
    selections out over.  Cached chunks are read-only and keyed by content
    hash, so they are immutable by construction; writers always mutate
    private copies.
    """

    def __init__(self, repo: Repository, snapshot_id: str, *, writable: bool,
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 read_workers: int = 1,
                 doc: Optional[Dict[str, Any]] = None):
        self.repo = repo
        self.snapshot_id = snapshot_id
        self.writable = writable
        # ``doc`` lets an opener that already holds the snapshot document
        # (the hinted coalesced open) skip the round trip re-fetching it
        self._doc = doc if doc is not None else repo._read_snapshot(snapshot_id)
        self._manifest_cache: Dict[str, Dict[str, str]] = {}
        self.cache_bytes = int(cache_bytes)
        self.read_workers = max(1, int(read_workers))
        # externally shared executor wins over the session-owned one (the
        # ETL pipeline lends its ingest pool here)
        self.read_pool = None
        self._own_pool = None
        self._cache_lock = threading.Lock()
        # manifest-object cache: shard/manifest hash -> {chunk key -> ref}
        self._obj_cache: "OrderedDict[str, Dict[str, str]]" = OrderedDict()
        # decoded-chunk cache: (ref, chunks, dtype, codec) -> read-only array
        self._chunk_cache: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._chunk_cache_nbytes = 0
        # chunk payloads actually fetched+decoded (cache misses) — the
        # "chunks read" accounting fragmentation benchmarks compare
        self._fetch_count = 0
        # cache keys a prefetch batch is currently fetching; the Event is
        # set when the batch lands so demand readers can wait instead of
        # issuing a duplicate GET
        self._inflight: Dict[Tuple, threading.Event] = {}
        # prefetched-but-not-yet-read cache keys: shielded from demand
        # eviction until first use, so a large demand burst cannot flush
        # the plan it is about to consume
        self._prefetch_hot: set = set()
        self._prefetch_hits = 0

    # -- caches / concurrency ------------------------------------------
    def reader_pool(self):
        """Executor for multi-chunk read fan-out; None means read serially."""
        if self.read_pool is not None:
            return self.read_pool
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
        """Release the session-owned reader pool (caches die with the
        session object)."""
        # take the pool reference under the same lock reader_pool()
        # creates it under: an unlocked check-then-clear can miss a pool
        # a concurrent first reader is building (leaked threads) or hand
        # that reader a pool this close() already shut down
        with self._cache_lock:
            pool, self._own_pool = self._own_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def __enter__(self) -> "Session":
        """Context-manager entry: the session itself."""
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Release the reader pool on scope exit; exceptions propagate.

        On a :class:`Transaction` this never commits — an uncommitted
        ``with`` block simply abandons its staged state.
        """
        self.close()

    def cache_stats(self) -> Dict[str, int]:
        """Point-in-time cache/prefetch counters (all under one lock, so
        the snapshot is internally consistent)."""
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

    def _obj_cache_put(self, mh: str, obj: Dict[str, str]) -> None:
        with self._cache_lock:
            self._obj_cache[mh] = obj
            self._obj_cache.move_to_end(mh)
            while len(self._obj_cache) > _OBJ_CACHE_ENTRIES:
                self._obj_cache.popitem(last=False)

    def _manifest_obj(self, mh: str) -> Dict[str, str]:
        """One manifest object (v2 shard or v1 flat map), LRU-cached."""
        with self._cache_lock:
            obj = self._obj_cache.get(mh)
            if obj is not None:
                self._obj_cache.move_to_end(mh)
                return obj
        obj = _loads(self.repo.store.get(f"manifests/{mh}.json"))
        self._obj_cache_put(mh, obj)
        return obj

    def _stats_obj(self, sh: str) -> Dict[str, list]:
        """One stat doc ({chunk key -> [min, max, valid]}), LRU-cached.

        Shares the manifest-object cache under a prefixed key — both are
        small content-addressed JSON maps with identical lifecycle.
        """
        ck = f"stats:{sh}"
        with self._cache_lock:
            obj = self._obj_cache.get(ck)
            if obj is not None:
                self._obj_cache.move_to_end(ck)
                return obj
        obj = _loads(self.repo.store.get(f"stats/{sh}.json"))
        self._obj_cache_put(ck, obj)
        return obj

    # -- chunk statistics (predicate-pushdown sidecars) -----------------
    def has_stats(self, array_path: str) -> bool:
        """Whether this snapshot carries any stat sidecar for the array."""
        return self._doc.get("stats", {}).get(array_path) is not None

    def chunk_stats(self, array_path: str, cid) -> Optional[list]:
        """``[min, max, valid_fraction]`` for one chunk, or None when
        unknown (pre-v3 snapshot, raw-blob staged chunk, never written).

        None always means "cannot prune"; callers must read the chunk.
        """
        entry = self._doc.get("stats", {}).get(array_path)
        if entry is None:
            return None
        # stats entries are always shard-aligned lists (the format was
        # born sharded in v3; there is no flat variant)
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
        """Full merged chunk map for one array (commit/gc path — reads
        every shard; partial reads go through :meth:`chunk_ref` instead)."""
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
        """Raw chunk payloads for several content hashes in **one**
        coalesced round trip.

        Duplicate refs fetch once; backends without :meth:`get_many`
        degrade to per-key GETs.  This is the batch primitive the
        prefetcher and the serve layer's ``/chunks`` endpoint share.
        """
        uniq = list(dict.fromkeys(refs))
        keys = [f"chunks/{r}" for r in uniq]
        get_many = getattr(self.repo.store, "get_many", None)
        if get_many is None:
            got = {k: self.repo.store.get(k) for k in keys}
        else:
            got = get_many(keys)
        return {r: got[f"chunks/{r}"] for r in uniq}

    def _prefetch_manifests(self, array_paths: Sequence[str], *,
                            stats: bool = False) -> int:
        """Warm the manifest-object cache for ``array_paths`` in one
        batched round trip; returns the number of objects fetched.

        With ``stats=True`` the arrays' stat sidecars ride in the same
        batch, so a planner about to prune pays no extra RTTs.
        """
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
        get_many = getattr(self.repo.store, "get_many", None)
        if get_many is None:
            got = {ok: self.repo.store.get(ok) for _, ok in missing}
        else:
            got = get_many([ok for _, ok in missing])
        for ck, ok in missing:
            self._obj_cache_put(ck, _loads(got[ok]))
        return len(missing)

    @staticmethod
    def _selection_slices(meta: ArrayMeta, selection) -> List[slice]:
        """Selection normalized to per-axis unit-step slices (ints become
        length-1 slices), the form :meth:`ChunkGrid.chunks_for_selection`
        accepts."""
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
        """Issue a prefetch plan: fetch the chunks a set of upcoming reads
        will need, batched per manifest shard and coalesced into
        :data:`PREFETCH_BATCH_KEYS`-sized GET groups.

        ``items`` is an iterable of array paths (whole array),
        ``(array_path, selection)`` pairs (the chunks intersecting the
        selection — exactly the set a demand read of that selection would
        fetch, so chunk-fetch accounting is unchanged), or
        ``(array_path, [cid, ...])`` pairs with an explicit **list** of
        chunk ids (how :meth:`Array.scan` prefetches only the chunks that
        survive stat pruning).  Manifest shards for every named array are
        warmed first in one batched round trip.

        Admission is planned against the decoded-chunk cache budget:
        chunks whose estimated decoded size would overflow ``cache_bytes``
        are *deferred* to demand paging rather than fetched and dropped.
        Writable sessions skip prefetching entirely (staged chunks shadow
        committed ones).  With ``wait=False`` the returned report's
        batches run on the reader pool in the background; call
        :meth:`PrefetchReport.wait` (or just start reading — demand reads
        wait on in-flight chunks) to synchronize.
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
        # admission + in-flight marking happen atomically, *before* any
        # batch is submitted: a demand read racing the plan either sees
        # the cached chunk or an in-flight marker it can wait on
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
        """Fetch one coalesced batch: a single ``get_many`` round trip,
        decode, admit each chunk, then release the in-flight markers
        (always — waiters must never hang on a failed batch)."""
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
        """Byte-budget admission for a prefetched chunk: insert and mark
        *hot* (shielded from demand eviction until first read), or drop it
        if the cache is full — speculation never evicts resident data."""
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
        fill value).  The cache key is the chunk's content hash plus its
        decode parameters, so identical payloads shared by several arrays
        decode once.  A miss on a chunk an active prefetch batch is
        already fetching waits for that batch instead of issuing a
        duplicate GET (with a timed fallback to a direct fetch, so a
        failed batch degrades to the old per-chunk path).
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

    def stage_chunk(self, array_path: str, cid, blob: bytes) -> None:
        raise PermissionError("read-only session")

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
        # (or None for raw-blob stages, whose contents we never decode —
        # the key's old stats must be *dropped*, not carried stale)
        self._staged_stats: Dict[str, Dict[str, Optional[list]]] = {}
        # one-shot memo for the v1/v2→v3 stats backfill: the commit CAS
        # loop rebuilds the snapshot doc per attempt, and the touched
        # array's committed chunk set cannot change across retries (a
        # concurrent write to it would raise ConflictError instead)
        self._backfill_memo: Dict[str, Dict[str, list]] = {}
        self._touched: set = set()
        self._closed = False
        self.encode_workers = 1
        # optional shared executor for commit-time encode: lets a pipelined
        # caller keep one work-conserving pool for decode *and* encode
        # instead of oversubscribing cores with a second pool
        self.encode_pool = None

    # -- schema edits ------------------------------------------------------
    def create_group(self, path: str, attrs: Optional[Dict[str, Any]] = None):
        parts = path.strip("/").split("/") if path.strip("/") else []
        # create intermediate groups implicitly; only *new* groups (or groups
        # whose attrs change) count as touched for conflict detection —
        # otherwise every transaction would conflict on the root group.
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
        # mark touched even when the group already existed: a rebase would
        # otherwise adopt the other writer's version of this group and
        # silently drop the attr update, and two writers updating the same
        # group would never be detected as a conflict
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
        import numpy as _np
        if _np.isnan(fill_value) and not _np.issubdtype(_np.dtype(dtype), _np.floating):
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

    def rechunk_array(self, path: str, chunks: Sequence[int]) -> Array:
        """Change an array's chunk grid, dropping every committed chunk
        reference (and stat sidecar) in this transaction's view.

        The caller re-stages the array's data under the new grid — this
        is the primitive behind :func:`repro_torch.store.compaction.compact`.
        Shape, dtype, attrs, codec and fill value are untouched, so a
        full re-stage of the same values reads back bitwise-identically.
        Pending staged writes are refused rather than silently re-keyed
        onto the new grid.
        """
        doc = self._doc["arrays"].get(path)
        if doc is None:
            raise NotFound(f"array {path!r}")
        if self._staged_arrays.get(path) or self._staged_chunks.get(path):
            raise RuntimeError(
                f"array {path!r} has staged writes; rechunk before writing"
            )
        chunks = tuple(int(c) for c in chunks)
        if len(chunks) != len(doc["shape"]):
            raise ValueError(
                f"chunks rank {len(chunks)} != shape rank {len(doc['shape'])}"
            )
        if any(c <= 0 for c in chunks):
            raise ValueError(f"chunk sizes must be positive: {chunks}")
        doc["chunks"] = list(chunks)
        # the old grid's manifest/stat entries describe chunk keys that no
        # longer exist under the new grid: drop them wholesale — the commit
        # rebuilds both from what the caller re-stages
        self._doc["manifests"].pop(path, None)
        self._doc.get("stats", {}).pop(path, None)
        self._staged_stats.pop(path, None)
        self._backfill_memo.pop(path, None)
        self._manifest_cache.pop(path, None)
        self._touched.add(path)
        return self.array(path)

    def delete_array(self, path: str) -> None:
        self._doc["arrays"].pop(path, None)
        self._doc["manifests"].pop(path, None)
        self._doc.get("stats", {}).pop(path, None)
        self._staged_chunks.pop(path, None)
        self._staged_arrays.pop(path, None)
        self._staged_stats.pop(path, None)
        self._backfill_memo.pop(path, None)
        self._manifest_cache.pop(path, None)
        self._touched.add(path)

    # -- chunk staging -------------------------------------------------
    def stage_chunk(self, array_path: str, cid, blob: bytes) -> None:
        """Content-address and persist the chunk now; reference it at commit.

        Writing payloads eagerly (before the ref flip) is the write-ahead
        log: chunks are invisible until the commit CAS succeeds.
        """
        ref = content_hash(blob)
        self.repo.store.put(f"chunks/{ref}", blob, if_not_exists=True)
        key = _chunk_key(tuple(cid))
        self._staged_chunks.setdefault(array_path, {})[key] = ref
        # a decoded stage of the same chunk earlier in this transaction is
        # now superseded — drop it, or the deferred commit-time encode
        # would silently overwrite this blob with the old payload
        self._staged_arrays.get(array_path, {}).pop(key, None)
        # the payload is opaque here: mark the key's stats unknown so the
        # commit drops any now-stale sidecar entry instead of keeping it
        self._staged_stats.setdefault(array_path, {})[key] = None
        self._touched.add(array_path)

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

    def chunk_stats(self, array_path: str, cid) -> Optional[list]:
        # chunks staged in this transaction shadow the snapshot's sidecar
        # stats, which describe the *old* payload; their own stats are only
        # computed at commit — report unknown so pruning never uses stale
        # bounds against uncommitted data
        key = _chunk_key(tuple(cid))
        if (key in self._staged_arrays.get(array_path, {})
                or key in self._staged_chunks.get(array_path, {})):
            return None
        return super().chunk_stats(array_path, cid)

    # -- commit ----------------------------------------------------------
    def commit(self, message: str, *, max_retries: int = 5) -> str:
        if self._closed:
            raise RuntimeError("transaction already committed/aborted")
        # encode + persist staged decoded chunks exactly once, before the
        # CAS loop (write-ahead: payloads land before the ref can flip)
        self._flush_staged_arrays()
        for _attempt in range(max_retries):
            new_doc = self._build_snapshot_doc(message)
            sid = self.repo._write_snapshot(new_doc)
            ok = self.repo.store.compare_and_swap(
                self.repo._ref_key(self.branch),
                _dumps({"snapshot": self.snapshot_id}),
                _dumps({"snapshot": sid}),
            )
            if ok:
                self._closed = True
                return sid
            # CAS failed: somebody committed under us.  Try to rebase.
            new_head = self.repo.branch_head(self.branch)
            head_doc = self.repo._read_snapshot(new_head)
            their_touched = set(head_doc.get("touched", []))
            # walk back to our parent collecting all touched paths
            sid_walk = head_doc.get("parent")
            while sid_walk is not None and sid_walk != self.snapshot_id:
                try:
                    d = self.repo._read_snapshot(sid_walk)
                except NotFound:
                    # gc(keep_history=False) expired the ancestry between
                    # the new head and our base while this transaction was
                    # open: the touched-set walk cannot complete, so a
                    # safe rebase is impossible — surface it as the
                    # conflict it is (retry loops replan on a fresh head)
                    raise ConflictError(
                        "cannot rebase: history between the new head and "
                        f"this transaction's base was expired by gc "
                        f"(missing snapshot {sid_walk}); retry on a fresh "
                        "session"
                    ) from None
                their_touched |= set(d.get("touched", []))
                sid_walk = d.get("parent")
            if sid_walk != self.snapshot_id or (their_touched & self._touched):
                raise ConflictError(
                    f"commit conflicts on {sorted(their_touched & self._touched)}"
                )
            # disjoint: rebase onto the new head and retry
            self._rebase_onto(new_head, head_doc)
        raise ConflictError("too many commit retries")

    def abort(self) -> None:
        self._closed = True
        self._staged_chunks.clear()
        self._staged_arrays.clear()
        self._staged_stats.clear()
        self._backfill_memo.clear()

    # -- internals -------------------------------------------------------
    def _flush_staged_arrays(self) -> None:
        jobs = []
        for path, chunks in self._staged_arrays.items():
            codec = ArrayMeta.from_doc(self._doc["arrays"][path]).codec
            for key, arr in chunks.items():
                jobs.append((path, key, arr, codec))

        def encode(job):
            path, key, arr, codec = job
            # the decoded chunk is in hand exactly once, here: computing
            # its sidecar stats now costs one pass over data the codec is
            # about to stream anyway
            stats = chunk_stats_summary(arr) if self.repo.writes_stats else None
            blob = encode_chunk(arr, codec)
            ref = content_hash(blob)
            # persist from the worker: refs are unique content addresses,
            # and put-if-not-exists is idempotent, so concurrent writers
            # (even of identical chunks) are safe; the file write also
            # releases the GIL, overlapping I/O with sibling encodes
            self.repo.store.put(f"chunks/{ref}", blob, if_not_exists=True)
            return path, key, ref, stats

        def drain(pending):
            # work-stealing worker: list.pop() is atomic under the GIL, so
            # the committing thread and pool threads share one job list —
            # flush runs at full width even while the pool finishes
            # earlier-queued work (e.g. pipelined decode-ahead)
            out = []
            while True:
                try:
                    job = pending.pop()
                except IndexError:
                    return out
                out.append(encode(job))

        parallel = self.encode_pool is not None or self.encode_workers > 1
        if parallel and len(jobs) > 1:
            if self.encode_pool is not None:
                pool, transient = self.encode_pool, None
            else:
                from concurrent.futures import ThreadPoolExecutor

                transient = ThreadPoolExecutor(max_workers=self.encode_workers)
                pool = transient
            try:
                pending = list(jobs)
                futures = [
                    pool.submit(drain, pending)
                    for _ in range(self.encode_workers)
                ]
                encoded = drain(pending)  # committing thread helps
                for f in futures:
                    encoded.extend(f.result())
            finally:
                if transient is not None:
                    transient.shutdown()
        else:
            encoded = [encode(j) for j in jobs]
        for path, key, ref, stats in encoded:
            self._staged_chunks.setdefault(path, {})[key] = ref
            if stats is not None:
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
        """Stats for every pre-existing chunk of an array with no sidecar.

        This is the lazy v1/v2→v3 migration, mirroring the v1→v2 manifest
        split: the first write touching an array written before the stats
        format pays one decode pass over that array's existing chunks
        (``skip_keys`` — the keys this commit overwrites — excluded), and
        every later commit is incremental again.
        """
        memo = self._backfill_memo.get(array_path)
        if memo is not None:
            return memo
        meta = ArrayMeta.from_doc(self._doc["arrays"][array_path])
        out: Dict[str, list] = {}
        for key, ref in self._manifest(array_path).items():
            if key in skip_keys:
                continue
            chunk = decode_chunk(self.get_blob(ref), tuple(meta.chunks),
                                 meta.dtype, meta.codec, writable=False)
            out[key] = chunk_stats_summary(chunk)
        self._backfill_memo[array_path] = out
        return out

    def _stats_entry(self, array_path: str,
                     staged: Dict[str, Optional[list]]) -> List[Optional[str]]:
        """Merge staged chunk stats into the array's sharded stats entry,
        rewriting only the shards whose keys changed (exactly the shards
        the manifest merge rewrites)."""
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
            for key, st in add.items():
                if st is None:  # unknown (raw-blob stage): drop, never lie
                    base.pop(key, None)
                else:
                    base[key] = st
            shards[si] = self._put_stats_obj(base) if base else None
        return shards

    def _build_snapshot_doc(self, message: str) -> Dict[str, Any]:
        manifests = dict(self._doc["manifests"])
        stats = dict(self._doc.get("stats", {}))
        for array_path, staged in self._staged_chunks.items():
            if self.repo.manifest_format == 1:
                merged = dict(self._manifest(array_path))
                merged.update(staged)
                manifests[array_path] = self._put_manifest_obj(merged)
            else:
                manifests[array_path] = self._sharded_entry(array_path,
                                                            staged)
            if self.repo.writes_stats:
                # every staged key gets an entry: a stat triple from the
                # commit-time encode pass, or None (raw-blob stage) which
                # deletes the key's stale sidecar
                sstats = self._staged_stats.get(array_path, {})
                stats[array_path] = self._stats_entry(
                    array_path, {key: sstats.get(key) for key in staged}
                )
            else:
                # an older-format writer cannot refresh sidecars; stale
                # bounds would corrupt pruning, so drop the array's entry
                stats.pop(array_path, None)
        doc = {
            "parent": self.snapshot_id,
            "message": message,
            # sanctioned wall-clock: written_at is provenance only and is
            # in _VOLATILE_SNAPSHOT_FIELDS, stripped before the id hash
            "written_at": time.time(),
            "touched": sorted(self._touched),
            "groups": self._doc["groups"],
            "arrays": self._doc["arrays"],
            "manifests": manifests,
        }
        if stats:
            # omitted when empty so pre-v3 archives keep byte-identical
            # snapshot documents (and therefore snapshot ids)
            doc["stats"] = stats
        return doc

    def _rebase_onto(self, new_head: str, head_doc: Dict[str, Any]) -> None:
        # adopt their groups/arrays/manifests/stats for untouched paths
        for coll in ("groups", "arrays", "manifests", "stats"):
            theirs = head_doc.get(coll, {})
            ours = self._doc.setdefault(coll, {})
            for path, val in theirs.items():
                if path not in self._touched:
                    ours[path] = val
            for path in list(ours):
                if path not in self._touched and path not in theirs:
                    del ours[path]
        self.snapshot_id = new_head
        self._manifest_cache.clear()
