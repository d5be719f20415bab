"""Background compaction: analysis-ready re-chunking of append-heavy archives.

The reference package's compaction pass, kept as this package's copy: the
same plan and the same commits, so a compaction run by either package on
the same archive gives the same snapshot id.

Operational ingest (one volume scan per append, like a live NEXRAD feed)
leaves an archive whose arrays read back through many short time chunks
and whose metadata accumulated one manifest-shard rewrite per commit.
Analysis workloads want the opposite layout — a QVP or point series wants
*tall* time chunks, a full-sweep render wants *scan-aligned* ones.  This
module is the maintenance pass that converts between the two without
breaking anything the store already promises:

* **Bitwise-identical reads.**  Compaction moves bytes between chunk
  layouts; it never touches values, shapes, dtypes, attrs, codecs or fill
  values.  Unwritten chunk *holes* are preserved: a region no old chunk
  covered stays unwritten under the new grid instead of being
  materialized as fill.
* **An ordinary commit.**  The rewrite stages through a normal
  :class:`~repro_torch.store.icechunk.Transaction` and lands via the same
  branch-ref CAS as every append, so a compaction racing a concurrent
  append *retries on top of the winner* (replanning against the new head)
  instead of losing either side; disjoint-array races rebase inside
  ``commit`` as usual.  History is preserved — the compaction snapshot's
  parent is the head it rewrote — and a compaction that finds nothing to
  do returns the head unchanged, without committing (idempotence:
  ``compact(); compact()`` yields the same snapshot id).
* **Exact sidecars, free.**  Re-staged chunks flow through the commit-time
  encode pass, which already computes ``[min, max, valid_fraction]`` stat
  triples, so predicate pushdown stays exact on the new layout.  The same
  property makes compaction the *migration* path for old archives: a v1
  flat manifest splits into shards and a pre-v3 array gains a full stat
  sidecar even when its chunk grid is already optimal.
* **Space is reclaimed by gc.**  Superseded chunks stay referenced by
  ancestor snapshots (time travel keeps working); once history older than
  the compaction is expired — ``Repository.gc(keep_history=False)`` —
  they are unreferenced and the existing grace-window sweep removes them.

Profiles pick the target layout:

``"timeseries"``
    Tall time chunks under a per-chunk byte budget (other axes
    unchanged), sized by :func:`repro_torch.store.chunks.plan_time_chunks`:
    new chunk boundaries nest old ones, so the rewrite reads each old
    chunk exactly once.  Optimizes point_series/QVP-style reads along
    time.
``"volume"``
    Scan-aligned: time chunk of 1 with the spatial axes merged into one
    chunk per scan, so a full-sweep read fetches exactly one chunk.
    1-d arrays (coordinates) fall back to the tall-time plan — splitting
    a coordinate vector per scan would be pure overhead.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .chunks import plan_time_chunks
from .icechunk import ConflictError, NotFound, Repository, Session
from .zarrlite import Array, ArrayMeta

# per-chunk byte budget for the tall-time profile: big enough that a
# season's point query reads a handful of chunks, small enough to keep
# partial reads partial (matches the paper's ~10 MB cloud-object sweet
# spot for range-request reads)
DEFAULT_TARGET_CHUNK_BYTES = 8 << 20


@dataclass(frozen=True)
class CompactionProfile:
    """Target chunk layout for one compaction pass."""

    name: str
    target_chunk_bytes: int = DEFAULT_TARGET_CHUNK_BYTES
    scan_aligned: bool = False

    def plan(self, meta: ArrayMeta) -> Tuple[int, ...]:
        """Planned chunk grid for one array (equal to ``meta.chunks``
        when the array is already in profile)."""
        shape, chunks = tuple(meta.shape), tuple(meta.chunks)
        if not shape or shape[0] <= 0:
            return chunks  # scalar or empty along time: nothing to merge
        if self.scan_aligned and len(shape) >= 2:
            return (1,) + tuple(max(1, int(s)) for s in shape[1:])
        return plan_time_chunks(
            shape, chunks, np.dtype(meta.dtype).itemsize,
            self.target_chunk_bytes,
        )


PROFILES = {
    "timeseries": CompactionProfile("timeseries"),
    "volume": CompactionProfile("volume", scan_aligned=True),
}
COMPACTION_PROFILE_NAMES = sorted(PROFILES)


def resolve_profile(
    profile: Union[str, CompactionProfile]
) -> CompactionProfile:
    """Coerce a profile name or instance to a :class:`CompactionProfile`."""
    if isinstance(profile, CompactionProfile):
        return profile
    try:
        return PROFILES[profile]
    except KeyError:
        raise ValueError(
            f"unknown compaction profile {profile!r}; "
            f"known: {sorted(PROFILES)}"
        ) from None


@dataclass(frozen=True)
class CompactionJob:
    """One array the planner decided to rewrite, and why."""

    path: str
    meta: ArrayMeta
    chunks: Tuple[int, ...]  # planned grid (== meta.chunks for stats/migrate)
    reason: str              # "rechunk" | "migrate" | "stats"


@dataclass
class ArrayCompaction:
    """Per-array before/after chunk layout of one compaction."""
    path: str
    reason: str
    chunks_before: Tuple[int, ...]
    chunks_after: Tuple[int, ...]
    n_chunks_before: int     # written chunk objects under the old grid
    n_chunks_after: int      # written chunk objects under the new grid


@dataclass
class CompactionReport:
    """Summary of one compaction run."""
    profile: str
    snapshot_id: str         # new head (committed) or the unchanged head
    committed: bool          # False: archive already in profile (no-op)
    arrays: List[ArrayCompaction] = field(default_factory=list)
    retries: int = 0         # head races lost (and replanned) on the way
    wall_s: float = 0.0

    @property
    def n_chunks_before(self) -> int:
        return sum(a.n_chunks_before for a in self.arrays)

    @property
    def n_chunks_after(self) -> int:
        return sum(a.n_chunks_after for a in self.arrays)


def plan_compaction(
    session, profile: Union[str, CompactionProfile],
    paths: Optional[Sequence[str]] = None,
) -> Tuple[CompactionProfile, List[CompactionJob]]:
    """Decide which arrays of a snapshot need rewriting, and why.

    Reasons, in priority order: ``"rechunk"`` (grid differs from the
    profile's plan), ``"migrate"`` (v1 flat manifest needs the shard
    split), ``"stats"`` (v3 writer, array has chunks but no sidecar —
    pre-v3 history).  An array matching none is in profile and skipped;
    no jobs at all means the whole snapshot is a no-op.
    """
    prof = resolve_profile(profile)
    wanted = None if paths is None else {p.strip("/") for p in paths}
    if wanted is not None:
        missing = wanted - set(session.list_arrays())
        if missing:
            raise NotFound(f"no such arrays: {sorted(missing)}")
    jobs: List[CompactionJob] = []
    for path in session.list_arrays():
        if wanted is not None and path not in wanted:
            continue
        meta = ArrayMeta.from_doc(session._doc["arrays"][path])
        planned = prof.plan(meta)
        entry = session._doc["manifests"].get(path)
        if planned != tuple(meta.chunks):
            reason = "rechunk"
        elif isinstance(entry, str):
            reason = "migrate"
        elif (session.repo.writes_stats and entry is not None
              and not session.has_stats(path)):
            reason = "stats"
        else:
            continue
        jobs.append(CompactionJob(path, meta, planned, reason))
    return prof, jobs


def _copy_array(src: Array, dst: Array) -> int:
    """Re-stage ``src``'s data into ``dst``'s grid, new-chunk by new-chunk.

    Pure holes — new chunks no written old chunk intersects — are skipped,
    staying unwritten (fill-valued on read, prunable for free).  Returns
    the number of chunks staged.
    """
    sgrid, dgrid = src.meta.grid, dst.meta.grid
    ssession = src._session
    written = 0
    for cid in dgrid.chunk_ids():
        sl = dgrid.chunk_slices(cid)
        if all(ssession.chunk_ref(src.path, ocid) is None
               for ocid in sgrid.chunks_for_selection(list(sl))):
            continue
        dst[sl] = src[sl]
        written += 1
    return written


def compact(
    repo: Repository,
    profile: Union[str, CompactionProfile] = "timeseries",
    *,
    branch: str = "main",
    paths: Optional[Sequence[str]] = None,
    max_retries: int = 5,
    read_workers: int = 1,
    message: Optional[str] = None,
) -> CompactionReport:
    """Rewrite a branch head into the profile's chunk layout.

    See the module docstring for the guarantees.

    ``paths`` restricts the pass to the named arrays; ``read_workers``
    fans both the source reads and the commit-time re-encodes out over a
    thread pool.  Each array is encoded and persisted (write-ahead) as
    soon as it is copied, so peak memory is one array's decoded data, not
    the archive's.
    """
    prof = resolve_profile(profile)
    t0 = time.perf_counter()
    for attempt in range(max_retries + 1):
        tx = repo.writable_session(branch, read_workers=read_workers)
        # every attempt's transaction releases its reader pool on every
        # exit — no-op return, conflict retry (``continue`` still runs
        # the finally), success, or a raised error mid-copy
        try:
            tx.encode_workers = max(1, int(read_workers))
            _, jobs = plan_compaction(tx, prof, paths)
            if not jobs:
                return CompactionReport(
                    profile=prof.name, snapshot_id=tx.snapshot_id,
                    committed=False, retries=attempt,
                    wall_s=time.perf_counter() - t0,
                )
            # source reads come from a read-only view pinned to the same
            # snapshot the transaction is based on: the rechunk below
            # drops the transaction's own view of the old chunks
            src_session = Session(repo, tx.snapshot_id, writable=False,
                                  read_workers=read_workers)
            arrays: List[ArrayCompaction] = []
            try:
                for job in jobs:
                    src = src_session.array(job.path)
                    n_before = len(src_session._manifest(job.path))
                    if job.chunks != tuple(job.meta.chunks):
                        dst = tx.rechunk_array(job.path, job.chunks)
                    else:
                        # migrate/stats rewrite: same grid, re-staged
                        # content dedups against the existing chunk
                        # objects
                        dst = tx.array(job.path)
                    n_after = _copy_array(src, dst)
                    tx._flush_staged_arrays()
                    arrays.append(ArrayCompaction(
                        job.path, job.reason, tuple(job.meta.chunks),
                        job.chunks, n_before, n_after,
                    ))
            finally:
                src_session.close()
            try:
                sid = tx.commit(
                    message or f"compact profile={prof.name} "
                               f"arrays={len(arrays)}"
                )
            except ConflictError:
                # a concurrent append won the head and touched an array
                # we rewrote; its data must survive, so replan from the
                # new head
                continue
            return CompactionReport(
                profile=prof.name, snapshot_id=sid, committed=True,
                arrays=arrays, retries=attempt,
                wall_s=time.perf_counter() - t0,
            )
        finally:
            tx.close()
    raise ConflictError(
        f"compaction lost the branch head {max_retries + 1} times; "
        "archive too write-hot, retry later or raise max_retries"
    )
