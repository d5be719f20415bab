"""Incremental products: patch gridded state forward as scans stream in.

A live feed appends one scan per commit.  Recomputing a CAPPI /
column-max / QPE accumulation from scratch at every new head costs
``O(T x C)``, although a new scan changes a strictly bounded part of
each product:

* **Row-append products** (CAPPI, column max): every output row is a
  pure function of one scan, so rows already computed never change;
  only the *new* rows are missing, and within them only the cells the
  site's beams actually reach.
* **QPE accumulation**: an integral over scans; each new scan *adds*
  one term, and only at gates where it rained.

Each product is maintained as a **versioned DataTree node** under
``products/`` in the reference package's layout.  An update

1. diffs the head against the state (``n_times`` attr vs the live
   ``time`` axis),
2. computes fresh values for exactly the touched cells of the new rows
   on the device: for the grids, the new rows in one ``grid_map`` launch
   over the cached device map, which computes the cells in reach (for
   column-max of every sweep, the max folded in) and writes NaN to the
   rest without a load; for QPE, each wet scan's term added in place by
   the ``grid_update`` CUDA kernel, a scatter at the ascending list of
   wet gates (dry gates are neither read nor written), and
3. appends/overwrites only the touched state chunks.

**Bitwise contract.**  At any head, the incremental state equals the
from-scratch product at that head bit for bit: row-append products
regrid through the same gather maps and kernel as the from-scratch path,
and streaming QPE uses the trailing-interval rectangle rule with a strict
left-to-right float32 fold (:func:`streaming_qpe` is the from-scratch
comparator).  The per-scan rain-rate terms are built on the host in
numpy float32, exactly as the reference package builds them, and only
the adds run on the device; float32 addition is the same IEEE operation
on both, so the states are also bitwise equal to the reference's.

The multi-repository mosaic (``kind="mosaic"``, :class:`IncrementalMosaic`)
keeps one such grid state in each member repository of a catalog and
recomposes the composite from the stored states with the host's exact
``np.fmax``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..store import Session
from ._device import DeviceLike, resolve_device
from .grid import (
    PRODUCTS_GROUP,
    CartesianGrid,
    GridProduct,
    _cappi_mapping,
    _default_grid,
    _discover_sweeps,
    _site_from_root,
    _sweep_geometry,
    _to_device,
    build_mapping,
    device_map,
    read_grid_product,
)
from .products import ProductRequest

# rectangle-rule weight of the very first scan ever seen by a stream
# (there is no preceding scan to measure a trailing interval against);
# matches the single-scan convention of repro_torch.radar.qpe._dt_weights
FIRST_SCAN_INTERVAL_S = 300.0


# ---------------------------------------------------------------------------
# Update accounting
# ---------------------------------------------------------------------------


@dataclass
class UpdateReport:
    """What one incremental catch-up did, and what it avoided."""

    name: str                    # state node name under products/
    kind: str                    # cappi | column_max | qpe
    n_new_scans: int
    cells_computed: int          # cells actually recomputed this update
    cells_full: int              # what a from-scratch rebuild at the same
    #                              head would compute (all scans x cells)
    chunk_fetches: int           # store chunks fetched by this update
    snapshot_id: Optional[str]   # state commit (None: nothing new)
    source_snapshot: str         # archive head the state now reflects

    @property
    def noop(self) -> bool:
        return self.snapshot_id is None


def _aggregate(name: str, kind: str, parts: Sequence[UpdateReport],
               head: str) -> UpdateReport:
    return UpdateReport(
        name=name, kind=kind,
        n_new_scans=sum(p.n_new_scans for p in parts),
        cells_computed=sum(p.cells_computed for p in parts),
        cells_full=sum(p.cells_full for p in parts),
        chunk_fetches=sum(p.chunk_fetches for p in parts),
        snapshot_id=next((p.snapshot_id for p in reversed(parts)
                          if p.snapshot_id is not None), None),
        source_snapshot=head,
    )


# ---------------------------------------------------------------------------
# Shared state-node plumbing
# ---------------------------------------------------------------------------


def _discover_vcp(session: Session) -> str:
    """The archive's sole VCP group (explicit ``vcp=`` required if >1)."""
    vcps = [g for g in session.list_groups()
            if g and "/" not in g and g != PRODUCTS_GROUP
            and "vcp_id" in session.group_attrs(g)
            and session.has_array(f"{g}/time")]
    if len(vcps) != 1:
        raise ValueError(
            f"cannot infer VCP (found {sorted(vcps)}); pass vcp= in the "
            "ProductRequest"
        )
    return vcps[0]


def _grid_doc(grid: CartesianGrid) -> Dict[str, float]:
    return {"lat_min": grid.lat_min, "lat_max": grid.lat_max,
            "lon_min": grid.lon_min, "lon_max": grid.lon_max,
            "ny": grid.ny, "nx": grid.nx}


def _grid_from_doc(g: Dict[str, Any]) -> CartesianGrid:
    return CartesianGrid(g["lat_min"], g["lat_max"], g["lon_min"],
                         g["lon_max"], int(g["ny"]), int(g["nx"]))


# ---------------------------------------------------------------------------
# Incremental gridded products (CAPPI / column max)
# ---------------------------------------------------------------------------


class IncrementalGridProduct:
    """Maintain ``products/<name>`` for a cappi/column_max request.

    The request's parameters are **pinned at first update** (recorded in
    the state node's attrs); later updates always reuse the stored grid,
    sweep list and method.  ``device`` is where the regrid runs:
    ``None`` means ``"cuda"``, and a missing GPU raises unless the caller
    passes ``device="cpu"``.
    """

    def __init__(self, repo, request: ProductRequest, *,
                 name: Optional[str] = None, branch: str = "main",
                 device: DeviceLike = None) -> None:
        if request.kind not in ("cappi", "column_max"):
            raise ValueError(
                f"incremental grid product needs kind cappi|column_max, "
                f"got {request.kind!r}"
            )
        self.repo = repo
        self.request = request
        self.branch = branch
        self.device = resolve_device(device)
        self.name = name or f"inc_{request.kind}_{request.moment}"
        self.base = f"{PRODUCTS_GROUP}/{self.name}"

    # -- reading ---------------------------------------------------------
    def read(self, session: Optional[Session] = None) -> GridProduct:
        """Materialize the current state as a :class:`GridProduct`."""
        own = session is None
        if session is None:
            session = self.repo.readonly_session(branch=self.branch)
        try:
            return read_grid_product(session, self.name)
        finally:
            if own:
                session.close()

    # -- updating --------------------------------------------------------
    def update(self) -> UpdateReport:
        """Catch the state up to the branch head (no-op when current)."""
        req = self.request
        session = self.repo.readonly_session(branch=self.branch)
        try:
            fetches0 = session.cache_stats()["chunk_fetches"]
            head = session.snapshot_id
            have_state = session.has_array(f"{self.base}/time")
            if have_state:
                attrs = session.group_attrs(self.base)
                params = dict(attrs.get("params", {}))
                vcp = params["vcp"]
                sweeps = [int(s) for s in params["sweeps"]]
                method = params.get("method", "nearest")
                grid = _grid_from_doc(attrs["grid"])
                t_prev = int(attrs.get("n_times",
                                       session.array(f"{self.base}/time")
                                       .shape[0]))
                t_last = attrs.get("t_last")
            else:
                vcp = req.vcp or _discover_vcp(session)
                sweeps = (list(req.sweeps) if req.sweeps is not None
                          else _discover_sweeps(session, vcp))
                method = req.method
                grid = None  # resolved after geometry is in hand
                t_prev, t_last = 0, None

            t_arr = session.array(f"{vcp}/time")
            t_now = int(t_arr.shape[0])
            if t_now < t_prev:
                raise ValueError(
                    f"archive {vcp}/time shrank ({t_now} < {t_prev}); "
                    f"delete products/{self.name} and rebuild"
                )
            site_lat, site_lon, site_alt = _site_from_root(session)
            az, rng, elevs = _sweep_geometry(session, vcp, sweeps)
            if grid is None:
                grid = req.grid or _default_grid(site_lat, site_lon, rng,
                                                 elevs, req.ny, req.nx)
            C = grid.n_cells
            if t_now == t_prev:
                return UpdateReport(self.name, req.kind, 0, 0,
                                    t_now * C, 0, None, head)

            tsl = (slice(t_prev, t_now),)
            session.prefetch(
                [(f"{vcp}/time", tsl)]
                + [(f"{vcp}/sweep_{si}/{req.moment}", tsl) for si in sweeps],
                wait=False)
            times_new = np.asarray(t_arr[tsl])
            if t_last is not None and times_new.size and \
                    float(times_new[0]) < float(t_last):
                raise ValueError(
                    f"non-monotone append on {vcp}/time "
                    f"({times_new[0]} < {t_last}); rebuild the state"
                )
            blocks = [np.asarray(
                session.array(f"{vcp}/sweep_{si}/{req.moment}")[tsl])
                for si in sweeps]
            t_new = t_now - t_prev
            rows, m = self._patch_rows(blocks, t_new, grid, site_lat,
                                       site_lon, site_alt, az, rng, elevs,
                                       method)
            fetches = session.cache_stats()["chunk_fetches"] - fetches0
        finally:
            session.close()

        sid = self._commit_rows(rows, times_new, grid, vcp, sweeps, method,
                                t_prev, t_now, head)
        return UpdateReport(self.name, req.kind, t_new, t_new * m,
                            t_now * C, fetches, sid, head)

    def _patch_rows(self, blocks: List[np.ndarray], t_new: int,
                    grid: CartesianGrid, site_lat: float, site_lon: float,
                    site_alt: float, az: np.ndarray, rng: np.ndarray,
                    elevs: Sequence[float], method: str
                    ) -> Tuple[np.ndarray, int]:
        """The new rows, (t_new, ny, nx), and the cells computed per row:
        one regrid on the device, which computes the cells in reach and
        writes NaN to the rest (exactly what the full regrid yields)."""
        req, dev = self.request, self.device
        if req.kind == "cappi":
            maps = [_cappi_mapping(site_lat, site_lon, site_alt, az, rng,
                                   elevs, grid, method, req.altitude_m)]
            fields = [_to_device(np.stack(blocks, axis=1), dev)]
        else:  # column_max
            maps = [build_mapping(site_lat, site_lon, az, rng, e, grid,
                                  method=method) for e in elevs]
            fields = [_to_device(block, dev) for block in blocks]
        dm = device_map(maps, fields[0].shape[1], fields[0].device)
        rows = ops.grid_map(fields, dm.gate_idx, dm.weights, order=dm.order,
                            mode=req.mode)
        # the live rows are the cells in reach (a built map's gates are
        # all in range)
        return (rows.cpu().numpy().reshape(t_new, grid.ny, grid.nx),
                dm.order.n_live)

    def _commit_rows(self, rows: np.ndarray, times_new: np.ndarray,
                     grid: CartesianGrid, vcp: str, sweeps: Sequence[int],
                     method: str, t_prev: int, t_now: int,
                     head: str) -> str:
        """Append the new rows; one-scan chunks, so no RMW reads."""
        req = self.request
        tx = self.repo.writable_session(self.branch)
        ny, nx = grid.ny, grid.nx
        if not tx.has_array(f"{self.base}/time"):
            params: Dict[str, Any] = {
                "vcp": vcp, "sweeps": [int(s) for s in sweeps],
                "method": method,
            }
            if req.kind == "cappi":
                params["altitude_m"] = float(req.altitude_m)
            tx.create_group(self.base, {
                "product": req.kind,
                "moment": req.moment,
                "grid": _grid_doc(grid),
                "params": params,
                "incremental": True,
            })
            tx.create_array(
                f"{self.base}/time", shape=(0,), dtype="float64",
                chunks=(1,),
                attrs={"_dims": ["time"],
                       "units": "seconds since 1970-01-01"},
            )
            lat = tx.create_array(
                f"{self.base}/latitude", shape=(ny,), dtype="float64",
                chunks=(ny,),
                attrs={"_dims": ["latitude"], "units": "degrees_north"},
            )
            lat.write_full(grid.lats())
            lon = tx.create_array(
                f"{self.base}/longitude", shape=(nx,), dtype="float64",
                chunks=(nx,),
                attrs={"_dims": ["longitude"], "units": "degrees_east"},
            )
            lon.write_full(grid.lons())
            tx.create_array(
                f"{self.base}/{req.moment}", shape=(0, ny, nx),
                dtype="float32", chunks=(1, ny, nx),
                attrs={"_dims": ["time", "latitude", "longitude"]},
            )
        t_arr = tx.resize_array(f"{self.base}/time", (t_now,))
        t_arr[t_prev:t_now] = np.asarray(times_new, np.float64)
        v_arr = tx.resize_array(f"{self.base}/{req.moment}",
                                (t_now, ny, nx))
        v_arr[t_prev:t_now] = rows.astype(np.float32, copy=False)
        tx.update_group_attrs(self.base, {
            "n_times": t_now,
            "t_last": float(times_new[-1]),
            "source_snapshot": head,
        })
        return tx.commit(
            f"incremental {req.kind} {self.name}: "
            f"+{t_now - t_prev} scans -> {t_now}"
        )


# ---------------------------------------------------------------------------
# Incremental QPE accumulation (streaming rectangle rule)
# ---------------------------------------------------------------------------


def _zr_rate_rows(dbz: np.ndarray, *, a: float, b: float) -> np.ndarray:
    """(T, A, R) dBZ -> (T, A, R) float32 rain rate, the Z-R math of
    :func:`repro_torch.radar.qpe.qpe_from_volumes` kept strictly in
    float32 on the host (numpy's ``power``, not the device's ``powf``)."""
    dbz = np.asarray(dbz, np.float32)
    dbz_c = np.clip(dbz, np.float32(5.0), np.float32(53.0))
    z_lin = np.power(np.float32(10.0), dbz_c / np.float32(10.0))
    rate = np.power(z_lin / np.float32(a), np.float32(1.0) / np.float32(b))
    return np.where(np.isfinite(dbz) & (dbz >= np.float32(5.0)),
                    rate, np.float32(0.0)).astype(np.float32)


def _rect_dt(times: np.ndarray, t_last: Optional[float]) -> np.ndarray:
    """Trailing-interval rectangle weights: ``dt_i = t_i - t_{i-1}``.

    ``t_last`` is the previous stream position (None at stream start,
    where the first scan gets :data:`FIRST_SCAN_INTERVAL_S`).
    """
    t = np.asarray(times, np.float64)
    prev = np.empty_like(t)
    prev[1:] = t[:-1]
    prev[0] = (t[0] - FIRST_SCAN_INTERVAL_S) if t_last is None else t_last
    return (t - prev).astype(np.float32)


def _fold_terms(accum: np.ndarray, rates: np.ndarray, dt_s: np.ndarray,
                *, sparse: bool = False, mode: str = "auto",
                device: DeviceLike = None) -> Tuple[np.ndarray, int]:
    """Strict left fold: one add per scan, in scan order.

    ``accum`` is the flattened (A*R,) float32 state.  Each scan's term is
    built on the host in numpy float32.  Without ``sparse`` the dense
    comparator adds the full term on the host.  With ``sparse`` the adds
    go through the ``grid_update`` kernel's in-place scatter on
    ``device`` and touch only gates where it rained: each wet scan keeps
    its ascending wet gates and their terms, the accumulation and all the
    scans' values and gates go up in one copy each, one launch per wet
    scan patches the state in scan order, and the folded state comes down
    in one copy.  The two are bitwise identical (adding +0.0 to a
    non-negative float32 is the identity).  Returns (state, cells
    touched).
    """
    touched = 0
    if not sparse:
        for i in range(rates.shape[0]):
            term = (rates[i].reshape(-1)
                    * (dt_s[i] / np.float32(3600.0))).astype(np.float32)
            accum = (accum + term).astype(np.float32)
            touched += term.size
        return accum, touched
    wet_vals, wet_cells = [], []
    for i in range(rates.shape[0]):
        term = (rates[i].reshape(-1)
                * (dt_s[i] / np.float32(3600.0))).astype(np.float32)
        wet = np.flatnonzero(term > 0.0)
        if wet.size:
            wet_vals.append(term[wet])
            wet_cells.append(wet.astype(np.int32))
            touched += int(wet.size)
    if not wet_vals:
        return accum, touched
    dev = resolve_device(device)
    vals_d = torch.from_numpy(np.concatenate(wet_vals)).to(dev)
    cells_d = torch.from_numpy(np.concatenate(wet_cells)).to(dev)
    acc_d = torch.from_numpy(np.array(accum, np.float32)).to(dev)[None, :]
    start = 0
    for v in wet_vals:
        stop = start + v.size
        ops.grid_scatter_(acc_d, vals_d[None, start:stop],
                          cells_d[start:stop], op="add", mode=mode)
        start = stop
    return acc_d.reshape(-1).cpu().numpy(), touched


def streaming_qpe(
    session: Session,
    *,
    vcp: str,
    sweep: int = 0,
    moment: str = "DBZH",
    a: float = 200.0,
    b: float = 1.6,
) -> "StreamingQPEState":
    """From-scratch comparator: fold the whole archive left to right.

    Bitwise-identical to what :class:`IncrementalQPE` accumulates scan
    by scan (same rectangle-rule weights, same float32 fold).  The dense
    fold runs on the host, as the reference package's does.
    """
    base = f"{vcp}/sweep_{sweep}"
    times = np.asarray(session.array(f"{vcp}/time").read())
    dbz = np.asarray(session.array(f"{base}/{moment}").read())
    A, R = dbz.shape[1], dbz.shape[2]
    accum = np.zeros(A * R, np.float32)
    dt = _rect_dt(times, None)
    accum, _ = _fold_terms(accum, _zr_rate_rows(dbz, a=a, b=b), dt)
    return StreamingQPEState(
        accum_mm=accum.reshape(A, R),
        seconds=float(np.float64(dt.astype(np.float64).sum())),
        n_scans=int(times.size),
        t_last=float(times[-1]) if times.size else None,
    )


@dataclass
class StreamingQPEState:
    """A rectangle-rule accumulation snapshot (incremental or rebuilt)."""

    accum_mm: np.ndarray         # (azimuth, range) float32
    seconds: float               # integrated seconds
    n_scans: int
    t_last: Optional[float]

    @property
    def total_hours(self) -> float:
        return self.seconds / 3600.0


class IncrementalQPE:
    """Maintain ``products/<name>`` as a streaming QPE accumulation.

    ``device`` is where the adds run: ``None`` means ``"cuda"``, and a
    missing GPU raises unless the caller passes ``device="cpu"``.
    """

    def __init__(self, repo, request: ProductRequest, *,
                 name: Optional[str] = None, branch: str = "main",
                 device: DeviceLike = None) -> None:
        if request.kind != "qpe":
            raise ValueError(f"incremental QPE needs kind='qpe', "
                             f"got {request.kind!r}")
        self.repo = repo
        self.request = request
        self.branch = branch
        self.device = resolve_device(device)
        self.name = name or f"inc_qpe_{request.moment}"
        self.base = f"{PRODUCTS_GROUP}/{self.name}"

    def read(self, session: Optional[Session] = None) -> StreamingQPEState:
        own = session is None
        if session is None:
            session = self.repo.readonly_session(branch=self.branch)
        try:
            attrs = session.group_attrs(self.base)
            return StreamingQPEState(
                accum_mm=session.array(f"{self.base}/accum_mm").read(),
                seconds=float(attrs["seconds"]),
                n_scans=int(attrs["n_scans"]),
                t_last=attrs.get("t_last"),
            )
        finally:
            if own:
                session.close()

    def update(self) -> UpdateReport:
        req = self.request
        sweep = int(req.sweep or 0)
        session = self.repo.readonly_session(branch=self.branch)
        try:
            fetches0 = session.cache_stats()["chunk_fetches"]
            head = session.snapshot_id
            vcp = req.vcp or _discover_vcp(session)
            base = f"{vcp}/sweep_{sweep}"
            have_state = session.has_array(f"{self.base}/accum_mm")
            if have_state:
                attrs = session.group_attrs(self.base)
                t_prev = int(attrs["n_scans"])
                t_last = attrs.get("t_last")
                seconds = float(attrs["seconds"])
                accum = np.asarray(
                    session.array(f"{self.base}/accum_mm").read(),
                    np.float32)
            else:
                t_prev, t_last, seconds, accum = 0, None, 0.0, None

            t_arr = session.array(f"{vcp}/time")
            t_now = int(t_arr.shape[0])
            gates = session.array(f"{base}/{req.moment}").shape
            A, R = int(gates[1]), int(gates[2])
            if t_now < t_prev:
                raise ValueError(
                    f"archive {vcp}/time shrank ({t_now} < {t_prev}); "
                    f"delete products/{self.name} and rebuild"
                )
            if t_now == t_prev:
                return UpdateReport(self.name, "qpe", 0, 0, t_now * A * R,
                                    0, None, head)
            if accum is None:
                accum = np.zeros(A * R, np.float32)
            else:
                accum = accum.reshape(-1)

            tsl = (slice(t_prev, t_now),)
            session.prefetch([(f"{vcp}/time", tsl),
                              (f"{base}/{req.moment}", tsl)], wait=False)
            times_new = np.asarray(t_arr[tsl])
            dbz_new = np.asarray(
                session.array(f"{base}/{req.moment}")[tsl])
            dt = _rect_dt(times_new, t_last)
            accum, touched = _fold_terms(
                accum, _zr_rate_rows(dbz_new, a=req.a, b=req.b), dt,
                sparse=True, mode=req.mode, device=self.device)
            seconds += float(np.float64(dt.astype(np.float64).sum()))
            if not have_state:
                az = session.array(f"{base}/azimuth").read()
                rg = session.array(f"{base}/range").read()
            fetches = session.cache_stats()["chunk_fetches"] - fetches0
        finally:
            session.close()

        tx = self.repo.writable_session(self.branch)
        if not tx.has_array(f"{self.base}/accum_mm"):
            tx.create_group(self.base, {
                "product": "qpe",
                "moment": req.moment,
                "params": {"vcp": vcp, "sweep": sweep,
                           "a": float(req.a), "b": float(req.b),
                           "rule": "rectangle-trailing"},
                "incremental": True,
            })
            tx.create_array(
                f"{self.base}/accum_mm", shape=(A, R), dtype="float32",
                chunks=(A, R), attrs={"_dims": ["azimuth", "range"]},
            )
            az_arr = tx.create_array(
                f"{self.base}/azimuth", shape=(A,), dtype="float32",
                chunks=(A,), attrs={"_dims": ["azimuth"]},
            )
            az_arr.write_full(np.asarray(az, np.float32))
            rg_arr = tx.create_array(
                f"{self.base}/range", shape=(R,), dtype="float32",
                chunks=(R,), attrs={"_dims": ["range"]},
            )
            rg_arr.write_full(np.asarray(rg, np.float32))
        tx.array(f"{self.base}/accum_mm").write_full(
            accum.reshape(A, R))
        tx.update_group_attrs(self.base, {
            "n_scans": t_now,
            "t_last": float(times_new[-1]),
            "seconds": seconds,
            "source_snapshot": head,
        })
        sid = tx.commit(
            f"incremental qpe {self.name}: +{t_now - t_prev} scans "
            f"-> {t_now}"
        )
        return UpdateReport(self.name, "qpe", t_now - t_prev, touched,
                            t_now * A * R, fetches, sid, head)


# ---------------------------------------------------------------------------
# Incremental mosaic (multi-repository composite)
# ---------------------------------------------------------------------------


@dataclass
class MosaicState:
    """The recomposed mosaic: per-repo products + exact fmax composite."""

    repo_ids: List[str]
    results: Dict[str, GridProduct]
    composite: np.ndarray        # (ny, nx)
    grid: CartesianGrid
    moment: str
    product: str


class IncrementalMosaic:
    """Per-repository incremental states + exact max recomposition.

    Each member repository carries its own
    :class:`IncrementalGridProduct` state node (written *into that
    repository*, so it versions with its archive); the composite is
    recomputed from the stored states with the same NaN-aware
    ``fmax`` reduction as
    :func:`repro_torch.catalog.federation.federated_mosaic`, on the host —
    max is exact, so recomposition preserves the bitwise contract.  Every
    member regrids on ``device`` (resolved once, here).
    """

    def __init__(self, catalog, request: ProductRequest, *,
                 name: Optional[str] = None,
                 device: DeviceLike = None) -> None:
        if request.kind != "mosaic":
            raise ValueError(f"incremental mosaic needs kind='mosaic', "
                             f"got {request.kind!r}")
        if request.product not in ("column_max", "cappi"):
            raise ValueError(
                f"unknown mosaic product {request.product!r} "
                "(column_max|cappi)"
            )
        self.catalog = catalog
        self.request = request
        self.device = resolve_device(device)
        entries = catalog.entries()
        repo_ids = sorted(request.repos) if request.repos else \
            sorted(entries)
        if not repo_ids:
            raise ValueError("catalog has no repositories to mosaic")
        self.repo_ids = repo_ids
        grid = request.grid or CartesianGrid.covering(
            [entries[rid].bbox for rid in repo_ids if rid in entries],
            request.ny, request.nx,
        )
        self.grid = grid
        self.name = name or f"inc_mosaic_{request.product}_{request.moment}"
        member_req = ProductRequest(
            kind="cappi" if request.product == "cappi" else "column_max",
            vcp=request.vcp, moment=request.moment, grid=grid,
            sweeps=request.sweeps, altitude_m=request.altitude_m,
            method=request.method, mode=request.mode,
        )
        self.members = {
            rid: IncrementalGridProduct(
                catalog.open_repository(rid, entry=entries.get(rid)),
                member_req, name=self.name,
                branch=entries[rid].branch if rid in entries else "main",
                device=self.device,
            )
            for rid in repo_ids
        }

    def update(self) -> UpdateReport:
        """Catch every member state up to its repository head."""
        parts = [self.members[rid].update() for rid in self.repo_ids]
        return _aggregate(self.name, "mosaic", parts,
                          head=";".join(p.source_snapshot for p in parts))

    def composite(self) -> MosaicState:
        """Recompose the mosaic from the stored per-repo states."""
        results = {rid: self.members[rid].read() for rid in self.repo_ids}
        composite = np.fmax.reduce(
            np.stack([results[rid].composite() for rid in self.repo_ids],
                     axis=0), axis=0,
        )
        return MosaicState(
            repo_ids=list(self.repo_ids),
            results=results,
            composite=composite,
            grid=self.grid,
            moment=self.request.moment,
            product=self.request.product,
        )


def incremental_product(target, request: ProductRequest, *,
                        name: Optional[str] = None, branch: str = "main",
                        device: DeviceLike = None):
    """Factory: the right incremental maintainer for a request.

    ``target`` is a :class:`repro_torch.store.Repository` for the
    per-site kinds (``cappi``/``column_max``/``qpe``) or a
    :class:`repro_torch.catalog.Catalog` for ``mosaic``, mirroring
    :func:`repro_torch.radar.products.compute_product`'s dispatch.
    ``device`` is where the maintainer computes: ``None`` means
    ``"cuda"``, and a missing GPU raises unless the caller passes
    ``device="cpu"``.
    """
    if request.kind == "mosaic":
        return IncrementalMosaic(target, request, name=name, device=device)
    if request.kind == "qpe":
        return IncrementalQPE(target, request, name=name, branch=branch,
                              device=device)
    if request.kind in ("cappi", "column_max"):
        return IncrementalGridProduct(target, request, name=name,
                                      branch=branch, device=device)
    raise ValueError(
        f"no incremental maintainer for kind {request.kind!r} "
        "(cappi|column_max|qpe|mosaic)"
    )


__all__ = [
    "FIRST_SCAN_INTERVAL_S",
    "IncrementalGridProduct",
    "IncrementalMosaic",
    "IncrementalQPE",
    "MosaicState",
    "StreamingQPEState",
    "UpdateReport",
    "incremental_product",
    "streaming_qpe",
]
