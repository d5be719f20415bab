"""Pruning query planner: predicate expressions → chunk-level read plans.

A query is a conjunction of small predicate expressions::

    from repro_torch.catalog import query as q
    result = q.query(
        catalog,
        q.time_between(t0, t1),
        q.moment("DBZH"),
        q.elevation(0.5),
        q.value_gt(50.0),            # "which chunks can contain > 50 dBZ?"
        q.within_box(35.0, 38.0, -99.0, -96.0),
    )

Planning resolves in three passes, cheapest first:

1. **catalog level** — site/box, VCP, elevation, moment and time-coverage
   predicates select (repository, vcp, sweep, moment) *targets* from the
   catalog document alone; unmatched repositories are never opened.
2. **array level** — the target's ``time`` coordinate turns the time
   window into a chunk-grid selection (paper-style partial read).
3. **chunk level** — per-chunk ``[min, max, valid_fraction]`` sidecars
   prune chunks that provably cannot satisfy the value predicates; such
   chunks are never fetched or decoded.

Execution with ``prune=False`` is the blind baseline: every chunk of
every target array is read and the same predicates applied as masks.
Both modes return bitwise-identical matches (the pruning-correctness
property pinned by ``tests/test_catalog.py``); only the chunk accounting
differs.  Archives without sidecars (pre-v3 snapshots) degrade to the
blind path automatically — stats lookups return "unknown", which never
prunes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..store.zarrlite import ScanStats, _stats_prune_cid

# ---------------------------------------------------------------------------
# Predicate expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TimeBetween:
    """Predicate: scan time within ``[t0, t1)``."""
    t0: float
    t1: float


@dataclass(frozen=True)
class Moment:
    """Predicate: the scan carries one of ``names``."""
    names: Tuple[str, ...]


@dataclass(frozen=True)
class Elevation:
    """Predicate: sweep elevation within ``tol`` degrees of ``deg``."""
    deg: float
    tol: float = 0.25


@dataclass(frozen=True)
class Sweep:
    """Predicate: restrict to sweep ``index``."""
    index: int


@dataclass(frozen=True)
class Vcp:
    """Predicate: restrict to volume coverage pattern ``name``."""
    name: str


@dataclass(frozen=True)
class Site:
    """Predicate: restrict to the given site ids."""
    ids: Tuple[str, ...]


@dataclass(frozen=True)
class Box:
    """Predicate: site location inside a lat/lon box."""
    lat_min: float
    lat_max: float
    lon_min: float
    lon_max: float


@dataclass(frozen=True)
class ValueGt:
    """Predicate: keep chunks that may contain values > ``threshold``."""
    threshold: float


@dataclass(frozen=True)
class ValueLt:
    """Predicate: keep chunks that may contain values < ``threshold``."""
    threshold: float


def time_between(t0: float, t1: float) -> TimeBetween:
    """Scans with ``t0 <= time <= t1`` (epoch seconds, inclusive)."""
    return TimeBetween(float(t0), float(t1))


def moment(*names: str) -> Moment:
    """Restrict to the named polarimetric moments (e.g. ``"DBZH"``)."""
    return Moment(tuple(names))


def elevation(deg: float, tol: float = 0.25) -> Elevation:
    """Sweeps whose fixed angle is within ``tol`` degrees of ``deg``."""
    return Elevation(float(deg), float(tol))


def sweep(index: int) -> Sweep:
    """Restrict to one sweep index (alternative to :func:`elevation`)."""
    return Sweep(int(index))


def vcp(name: str) -> Vcp:
    """Restrict to one volume coverage pattern (e.g. ``"VCP-212"``)."""
    return Vcp(name)


def site(*ids: str) -> Site:
    """Restrict to the named sites / repository ids."""
    return Site(tuple(ids))


def within_box(lat_min: float, lat_max: float,
               lon_min: float, lon_max: float) -> Box:
    """Repositories whose coverage footprint intersects the lat/lon box.

    The box is an ordinary interval box; a window crossing the
    antimeridian must be expressed as two boxes (one per hemisphere side,
    each its own query) — an inverted ``lon_min > lon_max`` is rejected
    rather than silently matching nothing.
    """
    if lat_min > lat_max:
        raise ValueError(f"inverted latitude box: {lat_min} > {lat_max}")
    if lon_min > lon_max:
        raise ValueError(
            f"inverted longitude box ({lon_min} > {lon_max}); an "
            "antimeridian-crossing window must be split into two boxes"
        )
    return Box(float(lat_min), float(lat_max), float(lon_min), float(lon_max))


def value_gt(threshold: float) -> ValueGt:
    """Matches where the moment value is strictly greater than threshold."""
    return ValueGt(float(threshold))


def value_lt(threshold: float) -> ValueLt:
    """Matches where the moment value is strictly less than threshold."""
    return ValueLt(float(threshold))


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Target:
    """One (repository, array) a query resolves to."""

    repo_id: str
    vcp: str
    sweep: int
    moment: str

    @property
    def base(self) -> str:
        return f"{self.vcp}/sweep_{self.sweep}"

    @property
    def array_path(self) -> str:
        return f"{self.base}/{self.moment}"

    @property
    def time_path(self) -> str:
        return f"{self.vcp}/time"


@dataclass
class QueryPlan:
    """A planned query: targets plus the pushed-down value/time filters."""
    targets: List[Target]
    time_window: Optional[Tuple[float, float]] = None
    value_gt: Optional[float] = None
    value_lt: Optional[float] = None
    # the catalog-entry snapshot the plan was built from: execution reuses
    # it, so one query = one catalog-document fetch and plan/execute can
    # never see two different catalog versions
    entries: Optional[Dict] = field(default=None, repr=False, compare=False)

    @property
    def repo_ids(self) -> List[str]:
        return sorted({t.repo_id for t in self.targets})


def _box_overlaps(bbox: Dict[str, float], box: Box) -> bool:
    if not bbox:
        return True  # unknown footprint: keep (conservative)
    return not (
        bbox.get("lat_max", 90.0) < box.lat_min
        or bbox.get("lat_min", -90.0) > box.lat_max
        or bbox.get("lon_max", 180.0) < box.lon_min
        or bbox.get("lon_min", -180.0) > box.lon_max
    )


def plan(catalog, *predicates, repos: Optional[Sequence[str]] = None
         ) -> QueryPlan:
    """Resolve predicates against the catalog into a :class:`QueryPlan`.

    Only the catalog document is consulted — no repository is opened.
    Targets come out sorted (repo, vcp, sweep, moment), which fixes the
    deterministic execution order everything downstream relies on.
    """
    # every repeated predicate kind intersects (the query is a
    # conjunction): windows/thresholds narrow, name sets intersect, and
    # list-valued kinds (elevations, boxes) must *all* accept a candidate
    tb: Optional[TimeBetween] = None
    moments: Optional[Tuple[str, ...]] = None
    elevs: List[Elevation] = []
    sweep_idxs: Optional[set] = None
    vcp_names: Optional[set] = None
    sites: Optional[set] = None
    boxes: List[Box] = []
    gt: Optional[float] = None
    lt: Optional[float] = None
    for p in predicates:
        if isinstance(p, TimeBetween):
            tb = p if tb is None else TimeBetween(max(tb.t0, p.t0),
                                                  min(tb.t1, p.t1))
        elif isinstance(p, Moment):
            moments = p.names if moments is None else tuple(
                n for n in moments if n in p.names
            )
        elif isinstance(p, Elevation):
            elevs.append(p)
        elif isinstance(p, Sweep):
            sweep_idxs = ({p.index} if sweep_idxs is None
                          else sweep_idxs & {p.index})
        elif isinstance(p, Vcp):
            vcp_names = ({p.name} if vcp_names is None
                         else vcp_names & {p.name})
        elif isinstance(p, Site):
            sites = set(p.ids) if sites is None else sites & set(p.ids)
        elif isinstance(p, Box):
            boxes.append(p)
        elif isinstance(p, ValueGt):
            gt = p.threshold if gt is None else max(gt, p.threshold)
        elif isinstance(p, ValueLt):
            lt = p.threshold if lt is None else min(lt, p.threshold)
        else:
            raise TypeError(f"unknown predicate {p!r}")

    entries = catalog.entries()
    targets: List[Target] = []
    for repo_id, entry in sorted(entries.items()):
        if repos is not None and repo_id not in repos:
            continue
        if sites is not None and (repo_id not in sites
                                  and entry.site_id not in sites):
            continue
        if any(not _box_overlaps(entry.bbox, b) for b in boxes):
            continue
        for vname, vinfo in sorted(entry.vcps.items()):
            if vcp_names is not None and vname not in vcp_names:
                continue
            if tb is not None and vinfo.get("time_min") is not None:
                if (vinfo["time_max"] < tb.t0 or vinfo["time_min"] > tb.t1):
                    continue  # coverage disjoint from the window
            for si, sinfo in sorted(vinfo.get("sweeps", {}).items(),
                                    key=lambda kv: int(kv[0])):
                if sweep_idxs is not None and int(si) not in sweep_idxs:
                    continue
                if any(abs(float(sinfo.get("elevation", 0.0)) - e.deg)
                       > e.tol for e in elevs):
                    continue
                for m in sinfo.get("moments", []):
                    if moments is not None and m not in moments:
                        continue
                    targets.append(Target(repo_id, vname, int(si), m))
    return QueryPlan(
        targets=targets,
        time_window=(tb.t0, tb.t1) if tb is not None else None,
        value_gt=gt,
        value_lt=lt,
        entries=entries,
    )


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def resolve_time_window(session, time_path: str,
                        window: Optional[Tuple[float, float]],
                        *, allow_mask: bool = True
                        ) -> Tuple[int, int, Optional[np.ndarray]]:
    """Resolve a time window to ``(i0, i1, row_mask)`` on one time axis.

    ``[i0, i1)`` is the covering index slice (the chunk selection).  For
    the common monotone axis (one ingest stream appends (vcp, time)-
    ordered) the slice is exact and ``row_mask`` is None.  A *backfilled*
    archive — a later ingest appending earlier scans — has a non-monotone
    axis, where the window may have interior gaps: then ``row_mask`` is a
    boolean over ``[i0, i1)`` selecting the in-window rows.  Chunk scans
    apply the mask post-read (identically in pruned and blind modes, so
    bitwise equality holds); contiguous-slice consumers (the science
    workflows) pass ``allow_mask=False`` and get a clear error instead
    of silently processing out-of-window scans.
    """
    arr = session.array(time_path)
    if window is None:
        # no predicate on time: the covering slice is the whole axis,
        # known from array metadata alone — no chunk read, no round trip
        return 0, int(arr.meta.shape[0]), None
    t = arr.read()
    n = int(t.size)
    sel = (t >= window[0]) & (t <= window[1])
    idx = np.nonzero(sel)[0]
    if idx.size == 0:
        return 0, 0, None
    i0, i1 = int(idx[0]), int(idx[-1]) + 1
    if i1 - i0 == idx.size:
        return i0, i1, None
    if not allow_mask:
        raise ValueError(
            f"{time_path}: the time window is not a contiguous index "
            "range (backfilled/non-monotone axis); run a scan query or "
            "narrow the window"
        )
    return i0, i1, sel[i0:i1]


@dataclass
class TargetScan:
    """Matches of one target's scan (see :class:`repro_torch.store.zarrlite.ScanResult`)."""

    target: Target
    time_bounds: Tuple[int, int]
    coords: Tuple[np.ndarray, ...]
    values: np.ndarray
    stats: ScanStats


@dataclass
class QueryResult:
    """Executed query output: matching scans plus read statistics."""
    scans: List[TargetScan] = field(default_factory=list)

    @property
    def n_matches(self) -> int:
        return int(sum(s.values.size for s in self.scans))

    def chunk_stats(self) -> ScanStats:
        total = ScanStats()
        for s in self.scans:
            total.merge(s.stats)
        return total

    @property
    def chunks_read(self) -> int:
        return self.chunk_stats().n_read

    @property
    def pruning_ratio(self) -> float:
        """Fraction of candidate chunks pruned without a read."""
        total = self.chunk_stats()
        return total.n_pruned / total.n_chunks if total.n_chunks else 0.0


def execute_target(session, target: Target, plan_: QueryPlan,
                   *, prune: bool = True,
                   time_bounds: Optional[Tuple[int, int,
                                               Optional[np.ndarray]]] = None
                   ) -> TargetScan:
    """Run one target of a plan against an open session.

    ``time_bounds`` lets bulk callers resolve each VCP's time window once
    and share it across that VCP's (sweep, moment) targets.
    """
    i0, i1, rmask = (time_bounds if time_bounds is not None
                     else resolve_time_window(session, target.time_path,
                                              plan_.time_window))
    arr = session.array(target.array_path)
    sel = (slice(i0, i1),) + tuple(
        slice(None) for _ in range(len(arr.shape) - 1)
    )
    res = arr.scan(sel, value_gt=plan_.value_gt, value_lt=plan_.value_lt,
                   prune=prune, pushdown=prune)
    coords, values = res.coords, res.values
    if rmask is not None and values.size:
        # backfilled axis: drop covering-slice rows outside the window —
        # applied identically for pruned and blind scans, so bitwise
        # equality between the two modes is preserved
        keep = rmask[coords[0] - i0]
        coords = tuple(c[keep] for c in coords)
        values = values[keep]
    return TargetScan(target, (i0, i1), coords, values, res.stats)


def prefetch_plan(session, targets: List[Target],
                  windows: Dict[str, Tuple[int, int, Optional[np.ndarray]]],
                  plan_: QueryPlan, *, prune: bool = True):
    """Issue a plan's chunk list as one asynchronous prefetch.

    This is the planner → prefetcher handoff: after the time windows are
    resolved, the exact chunk set every target's scan will read is known
    *before* any scan starts, so it can stream in (batched, shard-
    coalesced) while earlier targets compute.  With ``prune`` the
    sidecar-pruned chunks are excluded — the prefetcher fetches precisely
    what the scans would, keeping the gated fetch accounting identical;
    the blind baseline (``prune=False``) prefetches every chunk of every
    target array, matching its read-everything semantics.  Returns the
    :class:`~repro_torch.store.PrefetchReport` (unawaited — demand reads
    synchronize on in-flight chunks).
    """
    items = []
    session._prefetch_manifests(
        [t.array_path for t in targets], stats=prune)
    for target in targets:
        if not session.has_array(target.array_path):
            continue
        if not prune:
            items.append(target.array_path)  # blind scans read every chunk
            continue
        i0, i1, _ = windows[target.time_path]
        if i1 <= i0:
            continue
        arr = session.array(target.array_path)
        sels = [slice(i0, i1)] + [slice(None) for _ in arr.shape[1:]]
        cids = [
            cid for cid in arr.meta.grid.chunks_for_selection(sels)
            if not _stats_prune_cid(session, target.array_path, cid,
                                    plan_.value_gt, plan_.value_lt)
        ]
        items.append((target.array_path, cids))
    return session.prefetch(items, wait=False)


def run_repo_targets(session, targets: List[Target], plan_: QueryPlan,
                     *, prune: bool = True) -> List[TargetScan]:
    """Execute one repository's targets on an open session.

    Each VCP's time window is resolved exactly once.  The single inner loop shared by
    :func:`execute` and :func:`repro_torch.catalog.federation.federated_scan`
    (so sequential and federated results cannot diverge).

    On read-only sessions the loop is fronted by the prefetch handoff:
    every time axis is warmed in one batched round trip, windows resolve
    against cache, and :func:`prefetch_plan` streams the scans' chunk
    list in the background.
    """
    windows: Dict[str, Tuple[int, int, Optional[np.ndarray]]] = {}
    time_paths = list(dict.fromkeys(t.time_path for t in targets))
    session.prefetch(time_paths)  # one round trip for every time axis
    for tp in time_paths:
        windows[tp] = resolve_time_window(session, tp, plan_.time_window)
    prefetch_plan(session, targets, windows, plan_, prune=prune)
    return [
        execute_target(session, target, plan_, prune=prune,
                       time_bounds=windows[target.time_path])
        for target in targets
    ]


def execute(catalog, plan_: QueryPlan, *, prune: bool = True,
            read_workers: int = 1) -> QueryResult:
    """Execute a plan repository by repository, in deterministic order.

    ``prune=False`` is the blind baseline: chunk selection *and* sidecar
    pruning are both disabled, every chunk of every target array is read,
    and the predicates are applied as in-memory masks.
    """
    result = QueryResult()
    # reuse the plan's catalog snapshot: no re-fetch, no version skew
    entries = plan_.entries if plan_.entries is not None else catalog.entries()
    for repo_id in plan_.repo_ids:
        session = catalog.open_session(repo_id, entry=entries.get(repo_id),
                                       read_workers=read_workers)
        try:
            result.scans.extend(run_repo_targets(
                session,
                [t for t in plan_.targets if t.repo_id == repo_id],
                plan_, prune=prune,
            ))
        finally:
            session.close()
    return result


def query(catalog, *predicates, repos: Optional[Sequence[str]] = None,
          prune: bool = True, read_workers: int = 1) -> QueryResult:
    """Plan + execute in one call.

    Single-threaded; see
    :func:`repro_torch.catalog.federation.federated_scan` for the fan-out."""
    return execute(catalog, plan(catalog, *predicates, repos=repos),
                   prune=prune, read_workers=read_workers)
