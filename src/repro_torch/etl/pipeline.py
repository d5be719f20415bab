"""Raw2Zarr: four-stage ETL from raw volume files to the Radar DataTree.

Stage 1 **extract** — enumerate + read raw binary volumes from an object
store prefix (stand-in for the NEXRAD S3 bucket).
Stage 2 **transform** — decode each file into FM-301-structured volumes
(:mod:`repro_torch.etl.level2` plays the role of Xradar).
Stage 3 **tree construction** — group volumes by VCP, order by scan time.
Stage 4 **load** — append into the Icechunk-managed store transactionally;
one commit per ingest batch gives atomic, versioned archive growth
(live-append mode of §5.4).

:func:`ingest` runs the stages as a *pipeline* (the paper's "minimal
preprocessing, parallel computation" claim): extraction and decoding fan
out over a ``ThreadPoolExecutor`` — zlib/lzma/zstd decompression and the
NumPy unpack loops all release the GIL — while the main thread drains
decoded volumes **in a deterministic order** and commits batches.  Decode
of batch *k+1* overlaps the transactional commit of batch *k*.

Determinism under concurrency: the append order is fixed *before* any
decode runs, by sorting on the cheap fixed-size header
(:func:`repro_torch.etl.level2.peek_header`) — (vcp, scan_time), the same key
stage 3 always used.  Results are then consumed in submission order, so
``workers=1`` and ``workers=N`` build byte-identical snapshots.

The port of the reference package's pipeline, with a plain
``ThreadPoolExecutor`` where the reference wraps its pool for its race
sanitizer: the same raw files give the same snapshot ids in both packages.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core import fm301
from ..core.datatree import RadarArchive
from ..store import ObjectStore, Repository
from ..store.compaction import compact as compact_repository
from . import level2
from .generator import StormSimulator


# ---------------------------------------------------------------------------
# Archive generation (the "upstream data provider")
# ---------------------------------------------------------------------------

def generate_raw_archive(
    raw_store: ObjectStore,
    *,
    site_id: str = "KVNX",
    vcp_name: str = "VCP-212",
    t0: float = 1305849600.0,  # 2011-05-20, the paper's KVNX case
    n_scans: int = 8,
    seed: int = 0,
    n_az: Optional[int] = None,
    n_gates: Optional[int] = None,
    n_sweeps: Optional[int] = None,
) -> List[str]:
    """Write ``n_scans`` raw volume files; returns their object keys.

    ``n_az``/``n_gates``/``n_sweeps`` shrink the geometry for tests while
    preserving the VCP's elevation structure.
    """
    site = fm301.SITES[site_id]
    vcp = fm301.VCPS[vcp_name]
    if n_az or n_gates or n_sweeps:
        vcp = fm301.VCPDef(
            vcp.vcp_id,
            vcp.elevations[: n_sweeps or vcp.n_sweeps],
            n_az or vcp.n_azimuth,
            n_gates or vcp.n_gates,
            vcp.gate_m,
            vcp.interval_s,
        )
    sim = StormSimulator(seed=seed)
    keys = []
    for i in range(n_scans):
        t = t0 + i * vcp.interval_s
        vol = sim.volume(site, vcp, t)
        key = f"{site_id}/{vcp.name}/{site_id}_{int(t)}.l2"
        raw_store.put(key, level2.encode_volume(vol))
        keys.append(key)
    return keys


# ---------------------------------------------------------------------------
# The four ETL stages
# ---------------------------------------------------------------------------

@dataclass
class IngestReport:
    """Counts, snapshot ids and stage timings from one ingest run."""
    n_files: int = 0
    n_volumes: int = 0
    n_commits: int = 0
    bytes_read: int = 0
    snapshot_ids: List[str] = field(default_factory=list)
    workers: int = 1
    # busy-seconds per stage (summed across threads) + end-to-end wall time;
    # extract+decode busy > wall is exactly the pipelining win
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    # catalog-shaped coverage collected while volumes pass through the
    # pipeline: {"site": {...}, "vcps": {vcp: {time_min/max, n_times,
    # sweeps: {i: {elevation, moments, n_azimuth, n_gates, range_max_m}}}}.
    # Exactly what Catalog.update_from_report merges, so a catalogued
    # ingest never re-opens the repository it just wrote.
    coverage: Dict = field(default_factory=dict)
    # snapshot ids of background compactions run via auto_compact_every
    # (kept apart from snapshot_ids, which remain the ingest commits)
    compaction_ids: List[str] = field(default_factory=list)


def _observe_coverage(cov: Dict, vol: Dict) -> None:
    """Fold one decoded volume's metadata into a report's coverage doc.

    Never raises: coverage is advisory and an ingest must not abort
    mid-transaction over metadata.  A malformed volume is counted in
    ``cov["errors"]`` and skipped; a mixed-site feed is *recorded*
    (``sites_seen``) and coverage tracks the first site —
    :meth:`repro_torch.catalog.Catalog.update_from_report` rejects multi-site
    reports at registration time, after all commits have landed cleanly.
    """
    try:
        _fold_coverage(cov, vol)
    except Exception:  # noqa: BLE001 — see docstring contract
        cov["errors"] = int(cov.get("errors", 0)) + 1


def _fold_coverage(cov: Dict, vol: Dict) -> None:
    site = vol["site"]
    seen = cov.setdefault("sites_seen", [])
    if site.site_id not in seen:
        seen.append(site.site_id)
    s = cov.setdefault("site", {
        "site_id": site.site_id,
        "latitude": float(site.latitude),
        "longitude": float(site.longitude),
        "altitude": float(site.altitude_m),
    })
    if s["site_id"] != site.site_id:
        return  # foreign site: keep first-site coverage, flag via sites_seen
    vcp = vol["vcp"]
    t = float(vol["time"])
    v = cov.setdefault("vcps", {}).setdefault(vcp.name, {
        "vcp_id": vcp.vcp_id,
        "time_min": t,
        "time_max": t,
        "n_times": 0,
        "sweeps": {},
    })
    v["time_min"] = min(v["time_min"], t)
    v["time_max"] = max(v["time_max"], t)
    v["n_times"] += 1
    for si, sweep in enumerate(vol["sweeps"]):
        # prefer the VCP definition's fixed angle (a python float): it is
        # what append_scan records as the sweep's ``fixed_angle`` attr, so
        # report-driven and scan-driven catalog entries agree exactly
        # (decoded per-sweep elevations round-trip through float32)
        elev = (vcp.elevations[si] if si < len(vcp.elevations)
                else sweep["elevation"])
        d = v["sweeps"].setdefault(str(si), {
            "elevation": float(elev),
            "moments": [],
            "n_azimuth": 0,
            "n_gates": 0,
            "range_max_m": 0.0,
        })
        # geometry can grow across volumes (longer-range scans resize the
        # arrays); coverage must record the maximum or spatial pruning
        # would under-estimate the footprint and stop being conservative
        d["n_azimuth"] = max(d["n_azimuth"], int(len(sweep["azimuth"])))
        d["n_gates"] = max(d["n_gates"], int(len(sweep["range"])))
        if len(sweep["range"]):
            d["range_max_m"] = max(d["range_max_m"],
                                   float(sweep["range"][-1]))
        new = set(sweep["moments"]) - set(d["moments"])
        if new:
            d["moments"] = sorted(set(d["moments"]) | new)


def extract(raw_store: ObjectStore, keys: Iterable[str]):
    """Stage 1: stream raw bytes out of the object store."""
    for key in keys:
        yield key, raw_store.get(key)


def transform(raw_iter) -> Iterable[Dict]:
    """Stage 2: decode to FM-301 volumes (Xradar's role)."""
    for _key, blob in raw_iter:
        yield level2.decode_volume(blob)


def build_tree_order(volumes: Iterable[Dict]) -> List[Dict]:
    """Stage 3: order by (vcp, time) so appends are monotone per subtree.

    :func:`ingest` applies the same ordering *before* decode via
    :func:`repro_torch.etl.level2.peek_header`; the two keys are pinned
    equivalent by ``tests/test_torch_ingest.py``.  These four stage
    helpers remain the compositional API for callers that want to run or
    instrument stages individually.
    """
    vols = list(volumes)
    vols.sort(key=lambda v: (v["vcp"].name, v["time"]))
    return vols


def load(
    archive: RadarArchive,
    volumes: Sequence[Dict],
    *,
    batch_size: int = 16,
    message: str = "raw2zarr ingest",
) -> IngestReport:
    """Stage 4: transactional append, one commit per batch."""
    report = IngestReport()
    for start in range(0, len(volumes), batch_size):
        batch = volumes[start : start + batch_size]
        tx = archive.repo.writable_session(archive.branch)
        for vol in batch:
            archive.append_scan(vol, tx=tx, commit=False)
            _observe_coverage(report.coverage, vol)
            report.n_volumes += 1
        if not batch:
            # an empty transaction would still mint a snapshot and move
            # the head (the store's commit is unconditional); a batch with
            # no volumes must leave the archive byte-identical
            tx.abort()
            continue
        sid = tx.commit(f"{message} [{start}:{start + len(batch)}]")
        report.snapshot_ids.append(sid)
        report.n_commits += 1
    return report


# ---------------------------------------------------------------------------
# Pipelined end-to-end ingest
# ---------------------------------------------------------------------------

def ingest(
    raw_store: ObjectStore,
    repo: Repository,
    *,
    keys: Optional[Sequence[str]] = None,
    prefix: str = "",
    branch: str = "main",
    batch_size: int = 16,
    workers: int = 1,
    codec: Optional[str] = None,
    catalog=None,
    repo_id: Optional[str] = None,
    time_chunk: Optional[int] = None,
    auto_compact_every: Optional[int] = None,
    compact_profile: str = "timeseries",
) -> IngestReport:
    """Run all four stages end-to-end (Fig. 1 of the paper), pipelined.

    ``workers`` sizes the extract/decode pool.  Snapshot ids are identical
    for every ``workers`` value (see module docstring); ``codec`` selects
    the per-array chunk codec for newly created arrays.  Passing a
    :class:`repro_torch.catalog.Catalog` auto-registers the ingested coverage
    (under ``repo_id``, default the site id) from the metadata the
    pipeline already observed — the repository is not re-opened.

    ``time_chunk`` sets the scans-per-time-chunk of newly created arrays
    (a live scan-by-scan feed may want 1), and ``auto_compact_every=N``
    turns ingest into a self-maintaining background task: after every Nth
    commit the archive is compacted into ``compact_profile``'s
    analysis-ready layout (:mod:`repro_torch.store.compaction`).  Compaction is
    deterministic, so snapshot ids remain worker-count-independent.
    """
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if auto_compact_every is not None and auto_compact_every < 1:
        raise ValueError(
            f"auto_compact_every must be >= 1, got {auto_compact_every}"
        )
    # the knob is a parallelism *budget* (like make -j); heavy
    # oversubscription only adds GIL convoy, so cap the thread count near
    # the core count (one extra thread covers blocking I/O gaps and, on
    # share-throttled hosts, claims scheduler share the cores allow)
    n_threads = min(workers, (os.cpu_count() or workers) + 1)
    if keys is None:
        keys = sorted(raw_store.list(prefix))
    archive = RadarArchive(repo, branch, codec=codec, time_chunk=time_chunk)
    report = IngestReport(workers=workers)
    # per-call durations; list.append is atomic, so pool threads can report
    # without a lock
    extract_times: List[float] = []
    decode_times: List[float] = []
    load_s = 0.0
    t_wall = time.perf_counter()

    def _extract(key: str) -> Tuple[str, bytes]:
        t0 = time.perf_counter()
        blob = raw_store.get(key)
        extract_times.append(time.perf_counter() - t0)
        return key, blob

    def _decode(blob: bytes) -> Dict:
        t0 = time.perf_counter()
        vol = level2.decode_volume(blob)
        decode_times.append(time.perf_counter() - t0)
        return vol

    def _commit_batch(start: int, volumes, pool=None) -> None:
        """Append ``volumes`` (any iterable, possibly lazy) and commit.

        ``load_s`` accrues only append/commit work — when the iterable
        blocks on in-flight decodes, that stall is decode time, not load
        time.
        """
        nonlocal load_s
        tx = repo.writable_session(branch)
        # fan commit-time chunk encode out over the shared pipeline pool
        # (work-conserving with in-flight decodes) or a transient pool;
        # the same pool backs the transaction's read fan-out, so RMW
        # appends that touch many existing chunks share one set of threads
        tx.encode_pool = pool
        tx.encode_workers = n_threads
        tx.read_pool = pool
        n = 0
        for vol in volumes:
            t0 = time.perf_counter()
            archive.append_scan(vol, tx=tx, commit=False)
            _observe_coverage(report.coverage, vol)
            load_s += time.perf_counter() - t0
            report.n_volumes += 1
            n += 1
        if n == 0:
            # committing an empty transaction would still mint a snapshot
            # and move the head, and — worse — tick the auto-compaction
            # counter before any data landed.  Nothing staged: abort.
            tx.abort()
            return
        t0 = time.perf_counter()
        sid = tx.commit(f"raw2zarr ingest [{start}:{start + n}]")
        load_s += time.perf_counter() - t0
        report.snapshot_ids.append(sid)
        report.n_commits += 1
        if auto_compact_every and report.n_commits % auto_compact_every == 0:
            # maintenance between commits: no writer of ours is in
            # flight, so compaction can only race *external* appenders —
            # which it retries on top of (see repro_torch.store.compaction)
            crep = compact_repository(repo, compact_profile, branch=branch,
                                      read_workers=n_threads)
            if crep.committed:
                report.compaction_ids.append(crep.snapshot_id)

    if workers == 1:
        # serial reference path: stage by stage, no threads, no overlap
        raw = [_extract(k) for k in keys]
        report.n_files = len(raw)
        report.bytes_read = sum(len(b) for _k, b in raw)
        raw.sort(key=lambda kb: level2.peek_header(kb[1])[1:])
        vols = [_decode(blob) for _key, blob in raw]
        for start in range(0, len(vols), batch_size):
            _commit_batch(start, vols[start : start + batch_size])
    else:
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            # stage 1: fan out reads; keep key order for reporting only
            raw = [
                f.result() for f in [pool.submit(_extract, k) for k in keys]
            ]
            report.n_files = len(raw)
            report.bytes_read = sum(len(b) for _k, b in raw)
            # stage 3 first: fix the (vcp, time) append order from headers
            # alone, so stage-2 results can be consumed without a sort
            # barrier
            raw.sort(key=lambda kb: level2.peek_header(kb[1])[1:])
            # stage 2+4 pipelined: decode fans out with bounded lookahead
            # (about one commit batch ahead), and commit k's chunk encodes
            # are submitted to the *same* pool, so decode-ahead and
            # commit-time encode share the cores work-conservingly instead
            # of fighting from two oversubscribed pools
            lookahead = max(batch_size, n_threads) + n_threads
            futures = [
                pool.submit(_decode, blob)
                for _key, blob in raw[:lookahead]
            ]
            next_submit = len(futures)

            def _drain(batch_futures):
                # yield volumes as their decodes land (so the GIL-bound
                # staging memcpy in _commit_batch overlaps the pool's
                # in-flight decodes), topping the lookahead back up
                nonlocal next_submit
                for f in batch_futures:
                    vol = f.result()
                    if next_submit < len(raw):
                        futures.append(
                            pool.submit(_decode, raw[next_submit][1])
                        )
                        next_submit += 1
                    yield vol

            for start in range(0, len(raw), batch_size):
                _commit_batch(
                    start, _drain(futures[start : start + batch_size]), pool
                )

    report.stage_seconds = {
        "extract_s": sum(extract_times),
        "decode_s": sum(decode_times),
        "load_s": load_s,
        "wall_s": time.perf_counter() - t_wall,
    }
    if catalog is not None and report.n_volumes:
        entry = catalog.update_from_report(report, repo_id=repo_id,
                                           uri=repo.store.root, branch=branch,
                                           repo=repo)
        if report.compaction_ids:
            # compaction moved the head past the last ingest commit;
            # coverage is unchanged (re-chunking moves no data), so only
            # the recorded snapshot id needs a refresh
            catalog.note_snapshot(entry.repo_id, repo.branch_head(branch))
    return report
