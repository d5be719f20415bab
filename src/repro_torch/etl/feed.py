"""Live ingest: scan-by-scan transactional appends (§5.4 streaming mode).

:func:`repro_torch.etl.ingest` is the batch pipeline — it assumes the raw
archive already exists and commits many scans per transaction.  A live
radar delivers one volume every few minutes instead, and downstream
consumers (the incremental product machinery, catalog watchers, the
``/watch`` endpoint) want to see each scan as soon as it lands.

:class:`LiveFeed` is the streaming counterpart: it drains any iterator
of decoded FM-301 volumes — :func:`repro_torch.etl.generator.live_scan_feed`
in tests and benchmarks, a real decoder in production — and appends
**one scan per commit**, so every scan is an atomic, individually
addressable snapshot.  Invariants:

* **No empty commits.**  A poll that yields no scan commits nothing:
  the branch head moves only when data lands (the store's commit is
  unconditional, so the guard lives here — see the regression tests in
  ``tests/test_torch_ingest.py``).
* **Worker-count-independent snapshots.**  ``workers`` only sizes the
  commit-time chunk-encode fan-out (``Transaction.encode_workers``);
  append order is the feed order, so ``workers=1`` and ``workers=N``
  produce byte-identical snapshot ids.
* **Self-maintaining.**  ``auto_compact_every=N`` compacts the archive
  into the analysis-ready layout after every Nth *data* commit,
  mirroring :func:`repro_torch.etl.ingest`; only compactions that actually
  committed are recorded (and pushed to the catalog via
  ``note_snapshot``).
* **Catalog-visible.**  With a :class:`repro_torch.catalog.Catalog` attached,
  each committed scan merges its own coverage incrementally, so
  watchers polling the catalog see heads advance scan by scan.

The feed can run inline (:meth:`LiveFeed.ingest_next` from your own
loop) or as a background thread (:meth:`start` / :meth:`stop`); the
shared counters are guarded by ``LiveFeed._lock`` (a plain
``threading.Lock``: the reference's sanitizer hooks are not ported).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Iterator, List, Optional

from ..core.datatree import RadarArchive
from ..store import Repository
from ..store.compaction import compact as compact_repository
from .pipeline import IngestReport, _observe_coverage


class LiveFeed:
    """Append an iterator of volumes one scan (= one commit) at a time."""

    def __init__(
        self,
        repo: Repository,
        scans: Iterable[Dict],
        *,
        branch: str = "main",
        workers: int = 1,
        codec: Optional[str] = None,
        time_chunk: Optional[int] = 1,
        auto_compact_every: Optional[int] = None,
        compact_profile: str = "timeseries",
        catalog=None,
        repo_id: Optional[str] = None,
        message: str = "live feed",
    ) -> None:
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if auto_compact_every is not None and auto_compact_every < 1:
            raise ValueError(
                f"auto_compact_every must be >= 1, got {auto_compact_every}"
            )
        self.repo = repo
        self.branch = branch
        self.workers = workers
        self.auto_compact_every = auto_compact_every
        self.compact_profile = compact_profile
        self.catalog = catalog
        self.repo_id = repo_id
        self.message = message
        self._scans: Iterator[Dict] = iter(scans)
        self._archive = RadarArchive(repo, branch, codec=codec,
                                     time_chunk=time_chunk)
        self._report = IngestReport(workers=workers)
        # guards the scan iterator and the report counters: the inline
        # API and the background thread may be driven concurrently
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- observability ---------------------------------------------------
    @property
    def report(self) -> IngestReport:
        """The cumulative ingest report (a consistent view: the read
        orders against in-flight commits via the feed lock)."""
        with self._lock:
            return self._report

    def head(self) -> str:
        """Current branch head (one atomic ref read)."""
        return self.repo.branch_head(self.branch)

    # -- inline ingest ---------------------------------------------------
    def ingest_next(self, n: int = 1) -> List[str]:
        """Pull up to ``n`` scans and commit each one; return new ids.

        Stops early (returning fewer ids) when the scan source is
        exhausted; a poll that yields no scan opens no transaction and
        commits nothing.
        """
        sids: List[str] = []
        for _ in range(n):
            with self._lock:
                try:
                    vol = next(self._scans)
                except StopIteration:
                    break
                sids.append(self._commit_scan(vol))
        return sids

    def _commit_scan(self, vol: Dict) -> str:
        """One scan -> one transactional append -> one commit (+ upkeep).

        Caller holds ``_lock``.
        """
        tx = self.repo.writable_session(self.branch)
        # encode fan-out only: order and content are fixed by the feed,
        # so snapshot ids are identical for every ``workers`` value
        tx.encode_workers = self.workers
        self._archive.append_scan(vol, tx=tx, commit=False)
        scan_cov: Dict = {}
        _observe_coverage(scan_cov, vol)
        _observe_coverage(self._report.coverage, vol)
        t = float(vol["time"])
        sid = tx.commit(f"{self.message}: {vol['vcp'].name} @ {int(t)}")
        self._report.n_volumes += 1
        self._report.n_commits += 1
        self._report.snapshot_ids.append(sid)
        if self.catalog is not None and scan_cov.get("vcps"):
            # one-scan coverage delta: additive merges never double-count
            delta = IngestReport(coverage=scan_cov, snapshot_ids=[sid])
            entry = self.catalog.update_from_report(
                delta, repo_id=self.repo_id, uri=self.repo.store.root,
                branch=self.branch, repo=self.repo,
            )
            self.repo_id = entry.repo_id
        every = self.auto_compact_every
        if every and self._report.n_commits % every == 0:
            crep = compact_repository(self.repo, self.compact_profile,
                                      branch=self.branch,
                                      read_workers=self.workers)
            if crep.committed:
                self._report.compaction_ids.append(crep.snapshot_id)
                if self.catalog is not None and self.repo_id is not None:
                    self.catalog.note_snapshot(
                        self.repo_id, self.repo.branch_head(self.branch)
                    )
        return sid

    # -- background operation --------------------------------------------
    def run(self, *, max_scans: Optional[int] = None,
            interval_s: float = 0.0) -> int:
        """Drain scans until told to stop / source dries up / cap reached.

        Returns the number of scans committed by *this* call.  This is
        the background thread's body, public so operators can run a feed
        in the foreground.
        """
        done = 0
        while not self._stop.is_set():
            if max_scans is not None and done >= max_scans:
                break
            if not self.ingest_next(1):
                break  # source exhausted: a live source would block in
                # next() instead, so exhaustion means end-of-feed
            done += 1
            if interval_s > 0.0:
                self._stop.wait(interval_s)
        return done

    def start(self, *, max_scans: Optional[int] = None,
              interval_s: float = 0.0) -> "LiveFeed":
        """Run :meth:`run` in a daemon thread (idempotent while alive)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("feed already running; stop() it first")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run,
            kwargs={"max_scans": max_scans, "interval_s": interval_s},
            name="repro-torch-live-feed",
            daemon=True,
        )
        self._thread.start()
        return self

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Wait for a bounded background run (``max_scans=``) to finish.

        Returns ``True`` once the thread exited; does not signal a stop.
        """
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def stop(self, *, timeout: Optional[float] = 30.0) -> None:
        """Signal the background thread and wait for the in-flight scan.

        Commits are atomic, so stopping never leaves a torn scan: the
        feed finishes the scan it is on, then exits.
        """
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError("live feed did not stop in time")
            self._thread = None

    def __enter__(self) -> "LiveFeed":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["LiveFeed"]
