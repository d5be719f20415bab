"""Catalog index: the dataset-level (multi-repository) metadata document.

The store answers "read this array"; the catalog answers **Findable**
questions first — *which sites, VCPs, moments and time windows exist, and
in which repository?* — so a query planner can resolve work to concrete
(repository, array, chunk) read plans without opening every archive.

The catalog is one canonical-JSON document in an object store::

    {"version": 1,
     "repositories": {
        "KVNX": {"uri": "/path/or/bucket", "branch": "main",
                 "snapshot_id": "…",
                 "site": {"site_id", "latitude", "longitude", "altitude"},
                 "bbox": {"lat_min", "lat_max", "lon_min", "lon_max"},
                 "vcps": {"VCP-212": {"vcp_id", "time_min", "time_max",
                                      "n_times", "sweeps": {"0": {
                        "elevation", "moments", "n_azimuth", "n_gates",
                        "range_max_m"}}}}}}}

Updates go through the store's compare-and-swap primitive, so concurrent
registrations of different repositories merge instead of clobbering each
other.  Entries come from :meth:`Catalog.register_repository`, which
scans a repository's head, and :meth:`Catalog.note_snapshot` refreshes
one entry's recorded head after a maintenance commit.  The document's
bytes are those of the reference package's catalog, so either package
reads what the other registered.  The change feed (:meth:`Catalog.heads`,
:meth:`Catalog.poll_changes`, :meth:`Catalog.watch`) is the reference's
too; its ingest-time registration (``update_from_report``) waits for the
port of the ETL pipeline.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..radar import geometry
from ..store import ObjectStore, Repository
from ..store.codecs import json_dumps, json_loads

CATALOG_KEY = "catalog.json"
CATALOG_VERSION = 1


def coverage_bbox(site: Dict[str, Any], vcps: Dict[str, Any]) -> Dict[str, float]:
    """Geographic bounding box of a site's coverage.

    The radius is the largest ground range any catalogued sweep reaches
    (4/3-earth beam model via :mod:`repro_torch.radar.geometry`), converted to a
    lat/lon box around the site — intentionally a superset, so spatial
    pruning stays conservative.
    """
    lat = float(site.get("latitude", 0.0))
    lon = float(site.get("longitude", 0.0))
    reach = 0.0
    for vinfo in vcps.values():
        for sinfo in vinfo.get("sweeps", {}).values():
            rng = float(sinfo.get("range_max_m", 0.0))
            elev = float(sinfo.get("elevation", 0.0))
            if rng > 0.0:
                reach = max(reach, float(geometry.ground_range_m(rng, elev)))
    dlat, dlon = geometry.reach_box_deg(lat, reach)
    lon_min, lon_max = lon - dlon, lon + dlon
    if lon_min < -180.0 or lon_max > 180.0:
        # footprint crosses the antimeridian: an interval box cannot
        # represent it, so widen to all longitudes (superset, still
        # conservative — the box exists to *prune*, never to admit)
        lon_min, lon_max = -180.0, 180.0
    return {
        "lat_min": lat - dlat,
        "lat_max": lat + dlat,
        "lon_min": lon_min,
        "lon_max": lon_max,
    }


def scan_repository(repo: Repository, branch: str = "main") -> Dict[str, Any]:
    """Build a coverage document by walking one repository's head snapshot.

    Used by :meth:`Catalog.register_repository` for archives that were not
    ingested through a catalog-aware pipeline.
    """
    session = repo.readonly_session(branch=branch)
    root = session.group_attrs("")
    site = {
        "site_id": root.get("site_id", ""),
        "latitude": float(root.get("latitude", 0.0)),
        "longitude": float(root.get("longitude", 0.0)),
        "altitude": float(root.get("altitude", 0.0)),
    }
    vcps: Dict[str, Any] = {}
    groups = session.list_groups()
    for g in groups:
        if not g or "/" in g:
            continue
        attrs = session.group_attrs(g)
        if "vcp_id" not in attrs or not session.has_array(f"{g}/time"):
            continue
        t = session.array(f"{g}/time").read()
        vinfo: Dict[str, Any] = {
            "vcp_id": int(attrs["vcp_id"]),
            "time_min": float(t.min()) if t.size else None,
            "time_max": float(t.max()) if t.size else None,
            "n_times": int(t.size),
            "sweeps": {},
        }
        prefix = f"{g}/sweep_"
        for sg in groups:
            if not sg.startswith(prefix) or "/" in sg[len(prefix):]:
                continue
            sattrs = session.group_attrs(sg)
            moments = sorted(
                a.rsplit("/", 1)[-1]
                for a in session.list_arrays(f"{sg}/")
                if a.rsplit("/", 1)[-1] not in ("azimuth", "range")
                and "/" not in a[len(sg) + 1:]
            )
            rng = (session.array(f"{sg}/range").read()
                   if session.has_array(f"{sg}/range") else np.empty(0))
            az_n = (session.array(f"{sg}/azimuth").shape[0]
                    if session.has_array(f"{sg}/azimuth") else 0)
            vinfo["sweeps"][str(int(sattrs.get("sweep_number",
                                               sg[len(prefix):])))] = {
                "elevation": float(sattrs.get("fixed_angle", 0.0)),
                "moments": moments,
                "n_azimuth": int(az_n),
                "n_gates": int(rng.size),
                "range_max_m": float(rng.max()) if rng.size else 0.0,
            }
        vcps[g] = vinfo
    return {"site": site, "vcps": vcps, "snapshot_id": session.snapshot_id}


@dataclass
class CatalogEntry:
    """One repository's coverage, as recorded in the catalog document."""

    repo_id: str
    uri: str
    branch: str
    snapshot_id: Optional[str]
    site: Dict[str, Any]
    vcps: Dict[str, Any]
    bbox: Dict[str, float]

    @property
    def site_id(self) -> str:
        return self.site.get("site_id", self.repo_id)

    def time_range(self) -> Tuple[Optional[float], Optional[float]]:
        mins = [v["time_min"] for v in self.vcps.values()
                if v.get("time_min") is not None]
        maxs = [v["time_max"] for v in self.vcps.values()
                if v.get("time_max") is not None]
        return (min(mins) if mins else None, max(maxs) if maxs else None)

    def moments(self) -> List[str]:
        out: set = set()
        for v in self.vcps.values():
            for s in v.get("sweeps", {}).values():
                out.update(s.get("moments", []))
        return sorted(out)

    @staticmethod
    def from_doc(repo_id: str, doc: Dict[str, Any]) -> "CatalogEntry":
        return CatalogEntry(
            repo_id=repo_id,
            uri=doc.get("uri", ""),
            branch=doc.get("branch", "main"),
            snapshot_id=doc.get("snapshot_id"),
            site=dict(doc.get("site", {})),
            vcps=doc.get("vcps", {}),
            bbox=dict(doc.get("bbox", {})),
        )


class Catalog:
    """Multi-repository catalog over one canonical-JSON document."""

    def __init__(self, store_or_path, *, key: str = CATALOG_KEY):
        self.store = (
            store_or_path
            if isinstance(store_or_path, ObjectStore)
            else ObjectStore(store_or_path)
        )
        self.key = key
        # repositories registered in-process: saves a re-open per query
        self._attached: Dict[str, Repository] = {}

    # -- document plumbing ---------------------------------------------
    @classmethod
    def create(cls, store_or_path, *, key: str = CATALOG_KEY) -> "Catalog":
        """Create (or idempotently re-open) a catalog, writing the empty
        document if none exists yet."""
        cat = cls(store_or_path, key=key)
        cat.store.compare_and_swap(
            key, None,
            json_dumps({"version": CATALOG_VERSION, "repositories": {}}),
        )
        return cat

    @classmethod
    def open(cls, store_or_path, *, key: str = CATALOG_KEY) -> "Catalog":
        """Open an *existing* catalog — read-only storage friendly.

        A missing document raises instead of silently materializing an
        empty catalog (a mistyped path must fail loudly, not answer every
        query with zero matches).
        """
        cat = cls(store_or_path, key=key)
        if not cat.store.exists(key):
            raise KeyError(
                f"no catalog document {key!r} under {cat.store.root!r}; "
                "use Catalog.create() to start one"
            )
        return cat

    def _load(self) -> Tuple[Dict[str, Any], Optional[bytes]]:
        try:
            raw = self.store.get(self.key)
        except KeyError:
            return {"version": CATALOG_VERSION, "repositories": {}}, None
        return json_loads(raw), raw

    def _update(self, mutate: Callable[[Dict[str, Any]], None]
                ) -> Dict[str, Any]:
        """Read-modify-CAS loop.  ``mutate`` runs against a freshly loaded
        document on every attempt, so merges compose under contention."""
        for _ in range(32):
            doc, raw = self._load()
            mutate(doc)
            if self.store.compare_and_swap(self.key, raw, json_dumps(doc)):
                return doc
        raise RuntimeError("catalog update contention: too many CAS retries")

    # -- registration ----------------------------------------------------
    def to_doc(self) -> Dict[str, Any]:
        return self._load()[0]

    # -- registration ----------------------------------------------------
    def register_repository(
        self,
        repo_or_store_or_path,
        *,
        repo_id: Optional[str] = None,
        branch: str = "main",
        uri: Optional[str] = None,
    ) -> CatalogEntry:
        """Scan a repository's head snapshot and upsert its entry."""
        repo = (
            repo_or_store_or_path
            if isinstance(repo_or_store_or_path, Repository)
            else Repository.open(repo_or_store_or_path)
        )
        cov = scan_repository(repo, branch)
        rid = repo_id or cov["site"]["site_id"] or repo.store.root
        self._attached[rid] = repo
        # the entry is built *inside* the CAS closure from a scan that is
        # revalidated against the repository's current head on every
        # attempt: a dict captured before the loop would clobber a
        # concurrent commit and re-registration with the stale scanned head
        # (a lost update).  The memo keys on head, so the uncontended path
        # scans exactly once.
        memo = {"head": cov["snapshot_id"], "cov": cov}

        def mutate(doc: Dict[str, Any]) -> None:
            head = repo.branch_head(branch)
            if head != memo["head"]:
                memo["cov"] = scan_repository(repo, branch)
                memo["head"] = memo["cov"]["snapshot_id"]
            fresh = memo["cov"]
            doc["repositories"][rid] = {
                "uri": uri or repo.store.root,
                "branch": branch,
                "snapshot_id": fresh["snapshot_id"],
                "site": fresh["site"],
                "vcps": fresh["vcps"],
                "bbox": coverage_bbox(fresh["site"], fresh["vcps"]),
            }

        doc = self._update(mutate)
        return CatalogEntry.from_doc(rid, doc["repositories"][rid])

    # -- lookup ----------------------------------------------------------
    def note_snapshot(self, repo_id: str, snapshot_id: str) -> None:
        """Refresh one entry's recorded head snapshot without rescanning.

        For maintenance commits that change layout but not content —
        compaction's re-chunking (:mod:`repro_torch.store.compaction`) being
        the canonical case: coverage (sites, VCPs, moments, time windows,
        bbox) is already exact, so a full :meth:`register_repository`
        scan would be wasted I/O.  Unknown repo_ids raise — noting a
        snapshot for a repository the catalog never saw would fabricate
        an entry with no coverage.
        """
        def mutate(doc: Dict[str, Any]) -> None:
            try:
                doc["repositories"][repo_id]["snapshot_id"] = snapshot_id
            except KeyError:
                raise KeyError(
                    f"repository {repo_id!r} not in catalog"
                ) from None

        self._update(mutate)

    # -- lookup ----------------------------------------------------------
    def repository_ids(self) -> List[str]:
        return sorted(self._load()[0]["repositories"])

    def entries(self) -> Dict[str, CatalogEntry]:
        doc = self._load()[0]
        return {
            rid: CatalogEntry.from_doc(rid, e)
            for rid, e in sorted(doc["repositories"].items())
        }

    def entry(self, repo_id: str) -> CatalogEntry:
        doc = self._load()[0]
        try:
            return CatalogEntry.from_doc(repo_id,
                                         doc["repositories"][repo_id])
        except KeyError:
            raise KeyError(f"repository {repo_id!r} not in catalog") from None

    def open_repository(self, repo_id: str, *,
                        entry: Optional[CatalogEntry] = None) -> Repository:
        """Open (or return the attached) repository.  ``entry`` lets bulk
        callers that already loaded the catalog document skip a re-fetch."""
        repo = self._attached.get(repo_id)
        if repo is not None:
            return repo
        entry = entry if entry is not None else self.entry(repo_id)
        if not entry.uri:
            raise KeyError(
                f"repository {repo_id!r} has no uri and is not attached"
            )
        repo = Repository.open(entry.uri)
        self._attached[repo_id] = repo
        return repo

    # -- change feed -----------------------------------------------------
    def heads(self, *, entries: Optional[Dict[str, CatalogEntry]] = None
              ) -> Dict[str, Optional[str]]:
        """Current branch head of every catalogued repository.

        One atomic ref read per repository (the same CAS-backed read a
        commit races against, so a head observed here is never torn).
        Repositories this process cannot open — no recorded uri, remote
        storage offline — fall back to the entry's recorded
        ``snapshot_id``: stale at worst, and refreshed by ``note_snapshot`` (and the
        reference's ingest) on every commit, so watchers still converge.
        """
        entries = entries if entries is not None else self.entries()
        out: Dict[str, Optional[str]] = {}
        for rid in sorted(entries):
            entry = entries[rid]
            try:
                repo = self.open_repository(rid, entry=entry)
                out[rid] = repo.branch_head(entry.branch)
            except Exception:
                # unopenable from here: the recorded head is the
                # conservative answer (never invents a change)
                out[rid] = entry.snapshot_id
        return out

    def poll_changes(
        self, cursor: Optional[Dict[str, Optional[str]]] = None
    ) -> Tuple[List[Dict[str, Any]], Dict[str, Optional[str]]]:
        """One non-blocking change poll against a head cursor.

        ``cursor`` maps repo_id -> the last head the caller saw (the
        second element of the previous call's return; ``None`` / missing
        keys mean "never seen", so a fresh cursor reports every
        repository once).  Returns ``(changes, new_cursor)`` where each
        change is ``{"repo_id", "snapshot_id", "prev"}`` and
        ``new_cursor`` is the complete current head map — pass it back
        verbatim to resume.  Repositories dropped from the catalog
        simply leave the cursor; they are not reported as changes.
        """
        cursor = dict(cursor or {})
        heads = self.heads()
        changes: List[Dict[str, Any]] = []
        for rid, head in heads.items():
            prev = cursor.get(rid)
            if head != prev:
                changes.append(
                    {"repo_id": rid, "snapshot_id": head, "prev": prev}
                )
        return changes, heads

    def watch(
        self,
        cursor: Optional[Dict[str, Optional[str]]] = None,
        *,
        timeout_s: float = 30.0,
        poll_interval_s: float = 0.25,
    ) -> Tuple[List[Dict[str, Any]], Dict[str, Optional[str]]]:
        """Block until any repository head moves past ``cursor``.

        The long-poll primitive under ``GET /watch``: re-polls every
        ``poll_interval_s`` until :meth:`poll_changes` reports a change
        or ``timeout_s`` elapses, then returns ``(changes, new_cursor)``
        — ``changes == []`` means timeout, and the caller re-arms with
        the returned cursor.  A ``None`` cursor returns immediately with
        every repository (the bootstrap snapshot).
        """
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while True:
            changes, new_cursor = self.poll_changes(cursor)
            if changes or cursor is None:
                return changes, new_cursor
            remaining = deadline - time.monotonic()
            if remaining <= 0.0:
                return [], new_cursor
            time.sleep(min(max(0.0, float(poll_interval_s)), remaining))

    def open_session(self, repo_id: str, *,
                     entry: Optional[CatalogEntry] = None, **session_kw):
        """A read session on the repository's branch head (not on the
        entry's recorded snapshot, which may lag a commit)."""
        entry = entry if entry is not None else self.entry(repo_id)
        # the entry's recorded head doubles as a snapshot hint: when it is
        # still current the repository opens in one coalesced round trip
        if entry.snapshot_id and "snapshot_id" not in session_kw:
            session_kw.setdefault("snapshot_hint", entry.snapshot_id)
        return self.open_repository(repo_id, entry=entry).readonly_session(
            branch=entry.branch, **session_kw
        )
