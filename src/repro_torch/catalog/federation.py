"""Federation: run one query or science workflow across many repositories.

The catalog names the repositories; the planner picks the targets; this
module fans the per-repository work out over a thread pool (object-store
reads and codec decode release the GIL) and streams the results into the
science workflows — QVP, QPE, mosaics and point time series run across a
multi-site archive in one call.  Each repository is processed in its own
read session, whose ``read_workers`` pool keeps intra-repository chunk
fan-out; ordering is always sorted-``repo_id``, so federated results are
deterministic and bitwise-reproducible.

The reference package's module, routed to this package's own
:func:`repro_torch.radar.products.compute_product`: every per-repository
product is computed on ``device`` (resolved once by the caller), so a
federated QVP launches ``qvp_reduce`` once per repository, a QPE
``zr_accum`` and a mosaic ``grid_map``, from the pool's threads at once.
The mosaic's composite over sites stays ``np.fmax.reduce`` on the host,
as in the reference: exact, so grids stay bitwise.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..radar import (
    CartesianGrid,
    GridProduct,
    PointSeries,
    QPEResult,
    QVPResult,
    point_series_from_session,
)
from ..radar._device import DeviceLike
from ..radar.products import ProductRequest, compute_product
from .query import (
    Box,
    Elevation,
    Moment,
    QueryPlan,
    QueryResult,
    Sweep,
    Target,
    TimeBetween,
    Vcp,
    plan,
    resolve_time_window,
    run_repo_targets,
)


def _workflow_time_slice(session, target: Target,
                         plan_: QueryPlan) -> Tuple[int, int]:
    """A workflow consumes a contiguous time slice; gapped (backfilled)
    windows raise inside resolve_time_window via allow_mask=False."""
    i0, i1, _ = resolve_time_window(session, target.time_path,
                                    plan_.time_window, allow_mask=False)
    return i0, i1


def _structural_predicates(moment, vcp, sweep, elevation, time_between):
    preds = [Moment((moment,))]
    if vcp is not None:
        preds.append(Vcp(vcp))
    if sweep is not None:
        preds.append(Sweep(int(sweep)))
    if elevation is not None:
        preds.append(elevation if isinstance(elevation, Elevation)
                     else Elevation(float(elevation)))
    if time_between is not None:
        preds.append(TimeBetween(*time_between))
    return preds


def _one_target_per_repo(plan_: QueryPlan) -> "OrderedDict[str, Target]":
    """Workflow federation needs exactly one array per repository."""
    out: "OrderedDict[str, Target]" = OrderedDict()
    for t in plan_.targets:  # already sorted (repo, vcp, sweep, moment)
        if t.repo_id in out:
            prev = out[t.repo_id]
            raise ValueError(
                f"query is ambiguous for {t.repo_id!r}: both "
                f"{prev.array_path!r} and {t.array_path!r} match — add a "
                "vcp()/sweep()/elevation() predicate"
            )
        out[t.repo_id] = t
    if not out:
        raise ValueError("query matches no repository in the catalog")
    return out


def _fan_out(catalog, payloads: "OrderedDict[str, object]",
             fn: Callable, *, workers: Optional[int], read_workers: int,
             entries=None) -> "OrderedDict[str, object]":
    """Run ``fn(session, payload)`` per repository over a thread pool,
    preserving the mapping's (sorted-repo) order in the result."""
    if entries is None:  # one catalog-document fetch, not per repo
        entries = catalog.entries()

    def run(item):
        repo_id, payload = item
        session = catalog.open_session(repo_id, entry=entries.get(repo_id),
                                       read_workers=read_workers)
        try:
            return fn(session, payload)
        finally:
            session.close()

    items = list(payloads.items())
    # default is bounded: a 300-repository catalog must not spawn 300
    # threads (each session can lazily grow its own reader pool on top)
    n = (workers if workers is not None
         else min(len(items), 2 * (os.cpu_count() or 2)))
    if n <= 1 or len(items) <= 1:
        results = [run(it) for it in items]
    else:
        with ThreadPoolExecutor(max_workers=min(n, len(items)),
                                thread_name_prefix="repro-torch-fed") as pool:
            results = list(pool.map(run, items))
    return OrderedDict(zip(payloads.keys(), results))


# ---------------------------------------------------------------------------
# Federated scan (generic predicate query)
# ---------------------------------------------------------------------------


def federated_scan(catalog, *predicates, repos=None, prune: bool = True,
                   workers: Optional[int] = None,
                   read_workers: int = 1) -> QueryResult:
    """:func:`repro_torch.catalog.query.query`, with repositories in
    parallel."""
    plan_ = plan(catalog, *predicates, repos=repos)
    by_repo: "OrderedDict[str, List[Target]]" = OrderedDict()
    for t in plan_.targets:  # already sorted (repo, vcp, sweep, moment)
        by_repo.setdefault(t.repo_id, []).append(t)

    def run(session, targets: List[Target]):
        return run_repo_targets(session, targets, plan_, prune=prune)

    groups = _fan_out(catalog, by_repo, run, workers=workers,
                      read_workers=read_workers, entries=plan_.entries)
    result = QueryResult()
    for group in groups.values():
        result.scans.extend(group)
    return result


# ---------------------------------------------------------------------------
# Federated science workflows
# ---------------------------------------------------------------------------


@dataclass
class FederatedQVP:
    """Multi-site QVP result.

    Per-repository results plus their concatenation
    (profiles stacked along time, sorted-repo order)."""

    repo_ids: List[str]
    results: "OrderedDict[str, QVPResult]"
    profile: np.ndarray
    times: np.ndarray
    height_m: np.ndarray
    moment: str


@dataclass
class FederatedQPE:
    """Multi-site QPE result.

    One accumulation map per repository (site grids are
    distinct polar coordinate systems, so they are not summed)."""

    repo_ids: List[str]
    results: "OrderedDict[str, QPEResult]"

    @property
    def total_scans(self) -> int:
        return int(sum(r.n_scans for r in self.results.values()))


@dataclass
class FederatedPointSeries:
    """Multi-site point series: per-repository series + concatenation."""

    repo_ids: List[str]
    results: "OrderedDict[str, PointSeries]"
    values: np.ndarray
    times: np.ndarray
    moment: str


def federated_qvp(
    catalog,
    *,
    moment: str = "DBZH",
    vcp: Optional[str] = None,
    sweep: Optional[int] = None,
    elevation=None,
    time_between: Optional[Tuple[float, float]] = None,
    repos=None,
    quality_moment: Optional[str] = "RHOHV",
    quality_min: float = 0.85,
    mode: str = "auto",
    workers: Optional[int] = None,
    read_workers: int = 1,
    device: DeviceLike = None,
) -> FederatedQVP:
    """QVP across every catalogued repository the predicates match, each
    computed on ``device`` (see :func:`compute_product`)."""
    plan_ = plan(catalog,
                 *_structural_predicates(moment, vcp, sweep, elevation,
                                         time_between),
                 repos=repos)
    targets = _one_target_per_repo(plan_)

    def run(session, target: Target) -> QVPResult:
        ts = _workflow_time_slice(session, target, plan_)
        return compute_product(session, ProductRequest(
            kind="qvp", vcp=target.vcp, sweep=target.sweep,
            moment=target.moment, quality_moment=quality_moment,
            quality_min=quality_min, time_slice=ts, mode=mode,
        ), device=device)

    results = _fan_out(catalog, targets, run, workers=workers,
                       read_workers=read_workers, entries=plan_.entries)
    heights = [r.height_m for r in results.values()]
    if any(h.shape != heights[0].shape
           or not np.allclose(h, heights[0], rtol=1e-6, atol=1.0)
           for h in heights[1:]):
        # same gate count is not enough: different gate spacing or fixed
        # angles would silently misdescribe every site but the first
        raise ValueError(
            "federated QVP needs a common range/elevation geometry "
            "(per-site beam heights differ); query sites separately"
        )
    return FederatedQVP(
        repo_ids=list(results),
        results=results,
        profile=np.concatenate([r.profile for r in results.values()],
                               axis=0),
        times=np.concatenate([r.times for r in results.values()]),
        height_m=heights[0],
        moment=moment,
    )


def federated_qpe(
    catalog,
    *,
    moment: str = "DBZH",
    vcp: Optional[str] = None,
    sweep: int = 0,
    time_between: Optional[Tuple[float, float]] = None,
    repos=None,
    a: float = 200.0,
    b: float = 1.6,
    mode: str = "auto",
    workers: Optional[int] = None,
    read_workers: int = 1,
    device: DeviceLike = None,
) -> FederatedQPE:
    """Z–R accumulation per site across the federation, each on
    ``device``."""
    plan_ = plan(catalog,
                 *_structural_predicates(moment, vcp, sweep, None,
                                         time_between),
                 repos=repos)
    targets = _one_target_per_repo(plan_)

    def run(session, target: Target) -> QPEResult:
        ts = _workflow_time_slice(session, target, plan_)
        return compute_product(session, ProductRequest(
            kind="qpe", vcp=target.vcp, sweep=target.sweep,
            moment=target.moment, time_slice=ts, a=a, b=b, mode=mode,
        ), device=device)

    results = _fan_out(catalog, targets, run, workers=workers,
                       read_workers=read_workers, entries=plan_.entries)
    return FederatedQPE(repo_ids=list(results), results=results)


@dataclass
class FederatedMosaic:
    """Multi-site Cartesian composite on one shared lat/lon grid.

    ``results`` keeps each repository's full (time, ny, nx) product;
    ``composite`` collapses time *and* sites with a NaN-aware max (the
    national-composite convention for reflectivity) — a cell is NaN only
    where no site ever reached it inside the window.
    """

    repo_ids: List[str]
    results: "OrderedDict[str, GridProduct]"
    composite: np.ndarray        # (ny, nx)
    grid: CartesianGrid
    moment: str
    product: str

    @property
    def chunk_fetches(self) -> int:
        """Store chunks fetched across every repository (the pruning
        accounting benchmarks compare against a blind full-archive scan)."""
        return int(sum(r.chunk_fetches for r in self.results.values()))


def federated_mosaic(
    catalog,
    *,
    moment: str = "DBZH",
    product: str = "column_max",
    altitude_m: float = 2000.0,
    grid: Optional[CartesianGrid] = None,
    ny: int = 240,
    nx: int = 240,
    vcp: Optional[str] = None,
    sweep: Optional[int] = None,
    elevation=None,
    time_between: Optional[Tuple[float, float]] = None,
    within=None,
    repos=None,
    method: str = "nearest",
    mode: str = "auto",
    workers: Optional[int] = None,
    read_workers: int = 1,
    device: DeviceLike = None,
) -> FederatedMosaic:
    """Deprecated alias for the unified product API.

    Use ``compute_product(catalog, ProductRequest(kind="mosaic", ...))``
    from :mod:`repro_torch.radar.products`; results are bitwise identical.
    """
    import warnings

    warnings.warn(
        "federated_mosaic is deprecated; use repro_torch.radar.products."
        "compute_product with ProductRequest(kind='mosaic')",
        DeprecationWarning, stacklevel=2,
    )
    return compute_product(catalog, ProductRequest(
        kind="mosaic", moment=moment, product=product,
        altitude_m=altitude_m, grid=grid, ny=ny, nx=nx, vcp=vcp,
        sweep=sweep, elevation=elevation, time_between=time_between,
        within=within,
        repos=tuple(repos) if repos is not None else None,
        method=method, mode=mode,
    ), device=device, workers=workers, read_workers=read_workers)


def _federated_mosaic(
    catalog,
    *,
    moment: str = "DBZH",
    product: str = "column_max",
    altitude_m: float = 2000.0,
    grid: Optional[CartesianGrid] = None,
    ny: int = 240,
    nx: int = 240,
    vcp: Optional[str] = None,
    sweep: Optional[int] = None,
    elevation=None,
    time_between: Optional[Tuple[float, float]] = None,
    within=None,
    repos=None,
    method: str = "nearest",
    mode: str = "auto",
    workers: Optional[int] = None,
    read_workers: int = 1,
    device: DeviceLike = None,
) -> FederatedMosaic:
    # the mosaic implementation (dispatched via
    # repro_torch.radar.products), each site gridded on ``device``.
    # The planner does the pruning: repositories outside ``within`` (a
    # within_box predicate or a (lat_min, lat_max, lon_min, lon_max)
    # tuple) or with no coverage in ``time_between`` are never opened,
    # and each opened repository reads only the time chunks its planner
    # window resolves to.  ``product`` is "column_max" (all matched
    # sweeps) or "cappi" (constant ``altitude_m``); ``grid`` defaults to
    # the smallest grid covering the matched repositories' catalog
    # footprints, so mosaics are reproducible from the catalog document
    # alone.
    if product not in ("column_max", "cappi"):
        raise ValueError(
            f"unknown mosaic product {product!r} (column_max|cappi)"
        )
    preds = _structural_predicates(moment, vcp, sweep, elevation,
                                   time_between)
    if within is not None:
        preds.append(within if isinstance(within, Box)
                     else Box(*map(float, within)))
    plan_ = plan(catalog, *preds, repos=repos)
    by_repo: "OrderedDict[str, List[Target]]" = OrderedDict()
    for t in plan_.targets:  # already sorted (repo, vcp, sweep, moment)
        by_repo.setdefault(t.repo_id, []).append(t)
    if not by_repo:
        raise ValueError("query matches no repository in the catalog")
    for rid, targets in by_repo.items():
        vcps = sorted({t.vcp for t in targets})
        if len(vcps) > 1:
            raise ValueError(
                f"query is ambiguous for {rid!r}: VCPs {vcps} all match — "
                "add a vcp() predicate"
            )
    if grid is None:
        grid = CartesianGrid.covering(
            [plan_.entries[rid].bbox for rid in by_repo], ny, nx
        )

    def run(session, targets: List[Target]) -> GridProduct:
        vcp = targets[0].vcp
        sweeps = sorted({t.sweep for t in targets})
        fetches0 = session.cache_stats()["chunk_fetches"]
        # warm the serial prelude: the time axis and every sweep's
        # geometry arrays stream in one overlapped round trip instead of
        # back-to-back ones — on a high-RTT backend this collapses the
        # per-site latency floor before the gridder starts
        warm = ([f"{vcp}/time"]
                + [f"{vcp}/sweep_{si}/{a}" for si in sweeps
                   for a in ("azimuth", "range")])
        if plan_.time_window is None:
            # the window is structural (whole axis, resolved from array
            # metadata without a read), so the data chunks themselves can
            # join the warm-up batch — one chunk round trip total
            ts = _workflow_time_slice(session, targets[0], plan_)
            tsl = (slice(ts[0], ts[1]),)
            warm += [(f"{vcp}/sweep_{si}/{moment}", tsl) for si in sweeps]
            session.prefetch(warm, wait=False)
        else:
            # window resolution must read time values first; the moment
            # arrays still ride along with an *empty* chunk list so their
            # manifest shards join this round trip and the gridder's data
            # prefetch goes straight to chunks
            warm += [(f"{vcp}/sweep_{si}/{moment}", []) for si in sweeps]
            session.prefetch(warm, wait=False)
            ts = _workflow_time_slice(session, targets[0], plan_)
        req = ProductRequest(
            kind="cappi" if product == "cappi" else "column_max",
            vcp=vcp, moment=moment, grid=grid, sweeps=tuple(sweeps),
            altitude_m=altitude_m, time_slice=ts, method=method, mode=mode,
        )
        prod = compute_product(session, req, device=device)
        # re-base the fetch accounting on this whole call: the warm-up
        # above fetched chunks on the product's behalf *before* the
        # gridder snapshotted its own baseline, and those must stay
        # visible to the pruning benchmarks
        prod.chunk_fetches = (session.cache_stats()["chunk_fetches"]
                              - fetches0)
        return prod

    results = _fan_out(catalog, by_repo, run, workers=workers,
                       read_workers=read_workers, entries=plan_.entries)
    composite = np.fmax.reduce(
        np.stack([r.composite() for r in results.values()], axis=0), axis=0
    )
    return FederatedMosaic(
        repo_ids=list(results),
        results=results,
        composite=composite,
        grid=grid,
        moment=moment,
        product=product,
    )


def federated_point_series(
    catalog,
    *,
    moment: str = "DBZH",
    vcp: Optional[str] = None,
    sweep: int = 0,
    az_deg: float = 0.0,
    range_m: float = 50_000.0,
    halfwidth: int = 1,
    time_between: Optional[Tuple[float, float]] = None,
    repos=None,
    workers: Optional[int] = None,
    read_workers: int = 1,
) -> FederatedPointSeries:
    """Fixed-gate time series per site across the federation."""
    plan_ = plan(catalog,
                 *_structural_predicates(moment, vcp, sweep, None,
                                         time_between),
                 repos=repos)
    targets = _one_target_per_repo(plan_)

    def run(session, target: Target) -> PointSeries:
        ts = _workflow_time_slice(session, target, plan_)
        return point_series_from_session(
            session, vcp=target.vcp, sweep=target.sweep,
            moment=target.moment, az_deg=az_deg, range_m=range_m,
            halfwidth=halfwidth, time_slice=ts,
        )

    results = _fan_out(catalog, targets, run, workers=workers,
                       read_workers=read_workers, entries=plan_.entries)
    return FederatedPointSeries(
        repo_ids=list(results),
        results=results,
        values=np.concatenate([r.values for r in results.values()]),
        times=np.concatenate([r.times for r in results.values()]),
        moment=moment,
    )
