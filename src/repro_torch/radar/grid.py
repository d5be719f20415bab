"""Polar->Cartesian gridding: PPI, CAPPI and column-max products, write-back.

The gridded reflectivity products on a regular lat/lon grid, computed
from the DataTree store on the GPU:

1. **Map**: a :class:`GridMapping` inverts the beam geometry once per
   (site geometry, grid): for every Cartesian cell, the (at most) ``k``
   contributing gates as flat indices + weights.  Mappings are host-side
   numpy, pure functions of geometry, content-keyed and cached
   process-wide; the code is the reference package's, so the maps are
   bitwise equal to its maps.
2. **Gather**: one host->device copy of each (time, az, range) block,
   one launch of the ``grid_map`` CUDA kernel
   (:func:`repro_torch.kernels.ops.grid_map`; for column-max it folds
   every sweep with a NaN-aware max), and one device->host copy of the
   (time, ny, nx) result.  The kernel reads its map from the device in
   its traversal order (:func:`device_map`), built once per mapping and
   device.
3. **Write back**: gridded products land in the *same* repository as
   ordinary DataTree nodes under ``products/`` via a normal transaction,
   in the reference package's layout, so either package reads the
   other's products.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.grid_map import CellOrder, cell_order
from ..store import Session
from . import geometry
from ._device import DeviceLike, resolve_device
from ._selection import TimeSliceLike, as_time_slice

PRODUCTS_GROUP = "products"


# ---------------------------------------------------------------------------
# Target grid
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CartesianGrid:
    """Regular lat/lon target grid (cell centers, row 0 = southernmost).

    An interval box: a window crossing the antimeridian must be expressed
    as two grids.
    """

    lat_min: float
    lat_max: float
    lon_min: float
    lon_max: float
    ny: int
    nx: int

    def __post_init__(self):
        if self.lat_min >= self.lat_max:
            raise ValueError(
                f"inverted latitude extent: {self.lat_min} >= {self.lat_max}"
            )
        if self.lat_min < -90.0 or self.lat_max > 90.0:
            # beyond-pole latitudes would silently alias onto real cells
            # on the opposite meridian (sin(92 deg) == sin(88 deg))
            raise ValueError(
                f"latitude extent [{self.lat_min}, {self.lat_max}] leaves "
                "[-90, 90]"
            )
        if self.lon_min >= self.lon_max:
            raise ValueError(
                f"inverted longitude extent ({self.lon_min} >= "
                f"{self.lon_max}); split antimeridian-crossing grids in two"
            )
        if self.lon_min < -180.0 or self.lon_max > 180.0:
            raise ValueError(
                f"longitude extent [{self.lon_min}, {self.lon_max}] leaves "
                "[-180, 180]; split antimeridian-crossing grids in two"
            )
        if self.ny < 1 or self.nx < 1:
            raise ValueError(f"grid must be at least 1x1, got "
                             f"{self.ny}x{self.nx}")

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def n_cells(self) -> int:
        return self.ny * self.nx

    def lats(self) -> np.ndarray:
        """(ny,) cell-center latitudes, ascending."""
        edges = np.linspace(self.lat_min, self.lat_max, self.ny + 1)
        return (edges[:-1] + edges[1:]) / 2.0

    def lons(self) -> np.ndarray:
        """(nx,) cell-center longitudes, ascending."""
        edges = np.linspace(self.lon_min, self.lon_max, self.nx + 1)
        return (edges[:-1] + edges[1:]) / 2.0

    def mesh(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ny, nx) lat/lon cell-center fields."""
        return np.meshgrid(self.lats(), self.lons(), indexing="ij")

    @classmethod
    def around(cls, site_lat: float, site_lon: float, half_extent_m: float,
               ny: int = 240, nx: int = 240) -> "CartesianGrid":
        """Square grid centred on a site, ``half_extent_m`` to each edge.

        Clamped to the valid lat/lon intervals: near a pole or the
        antimeridian the grid covers the in-range side only.
        """
        dlat, dlon = geometry.reach_box_deg(site_lat, half_extent_m)
        return cls(max(site_lat - dlat, -90.0), min(site_lat + dlat, 90.0),
                   max(site_lon - dlon, -180.0),
                   min(site_lon + dlon, 180.0), ny, nx)

    @classmethod
    def covering(cls, bboxes: Sequence[Dict[str, float]],
                 ny: int = 240, nx: int = 240) -> "CartesianGrid":
        """Smallest grid covering a set of catalog-entry bounding boxes,
        clamped like :meth:`around`."""
        boxes = [b for b in bboxes if b]
        if not boxes:
            raise ValueError("no bounding boxes to cover")
        return cls(
            max(min(b["lat_min"] for b in boxes), -90.0),
            min(max(b["lat_max"] for b in boxes), 90.0),
            max(min(b["lon_min"] for b in boxes), -180.0),
            min(max(b["lon_max"] for b in boxes), 180.0),
            ny, nx,
        )


# ---------------------------------------------------------------------------
# Gate maps
# ---------------------------------------------------------------------------


@dataclass
class GridMapping:
    """Precomputed gate->cell gather map for one sweep geometry x grid.

    ``gate_idx[c, j]`` is a flat index into the sweep's flattened
    ``(azimuth, range)`` axis; ``weights[c, j] <= 0`` marks a missing
    neighbour.  Cells beyond the sweep's reach have all-zero weights and
    grid to NaN.
    """

    grid: CartesianGrid
    gate_idx: np.ndarray        # (C, k) int32
    weights: np.ndarray         # (C, k) float32
    n_az: int
    n_gates: int
    method: str
    elev_deg: float
    key: str = ""               # the content key it is cached under

    @property
    def n_cells(self) -> int:
        return self.gate_idx.shape[0]

    def in_reach(self) -> np.ndarray:
        """(C,) bool: cells with at least one contributing gate."""
        return (self.weights > 0.0).any(axis=1)


_MAPPING_CACHE: "OrderedDict[str, GridMapping]" = OrderedDict()
_MAPPING_CACHE_MAX = 64
_MAPPING_LOCK = threading.Lock()
_MAPPING_STATS = {"hits": 0, "misses": 0}


def mapping_cache_stats() -> Dict[str, int]:
    """Counters of the process-wide mapping cache."""
    with _MAPPING_LOCK:
        return dict(_MAPPING_STATS, entries=len(_MAPPING_CACHE))


def clear_mapping_cache() -> None:
    """Drop every cached polar-to-grid mapping."""
    with _MAPPING_LOCK:
        _MAPPING_CACHE.clear()
        _MAPPING_STATS.update(hits=0, misses=0)
        _DEVICE_MAPS.clear()


def _cache_get(key: str) -> Optional[GridMapping]:
    with _MAPPING_LOCK:
        hit = _MAPPING_CACHE.get(key)
        if hit is not None:
            _MAPPING_CACHE.move_to_end(key)
            _MAPPING_STATS["hits"] += 1
        return hit


def _cache_put(key: str, mapping: GridMapping) -> GridMapping:
    # the cached mapping is shared process-wide: freeze its arrays so an
    # in-place edit by one caller cannot poison every later regrid
    mapping.gate_idx.flags.writeable = False
    mapping.weights.flags.writeable = False
    mapping.key = key
    with _MAPPING_LOCK:
        _MAPPING_STATS["misses"] += 1
        _MAPPING_CACHE[key] = mapping
        _MAPPING_CACHE.move_to_end(key)
        while len(_MAPPING_CACHE) > _MAPPING_CACHE_MAX:
            _MAPPING_CACHE.popitem(last=False)
    return mapping


def _content_key(prefix: str, int_parts: Sequence[int],
                 *float_parts) -> str:
    """sha256 over length-prefixed int64/float64 parts.  The leading
    length vector doubles as the delimiter: without it, different
    (azimuth, range) splits of one concatenated byte stream collide."""
    h = hashlib.sha256()
    h.update(np.asarray(list(int_parts)
                        + [len(np.atleast_1d(p)) for p in float_parts],
                        np.int64).tobytes())
    for part in float_parts:
        h.update(np.asarray(part, np.float64).tobytes())
    return f"{prefix}:{h.hexdigest()}"


def _grid_parts(grid: CartesianGrid):
    return [grid.lat_min, grid.lat_max, grid.lon_min, grid.lon_max]


def _mapping_key(site_lat, site_lon, azimuth, range_m, elev_deg, grid,
                 method, power) -> str:
    return _content_key(
        method, [grid.ny, grid.nx],
        [site_lat, site_lon, elev_deg, float(power)],
        azimuth, range_m, _grid_parts(grid),
    )


def _circular_neighbours(azimuth: np.ndarray, az_cell: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Indices of the two azimuths bracketing each cell bearing (wrapped)."""
    order = np.argsort(azimuth, kind="stable")
    az_sorted = azimuth[order]
    pos = np.searchsorted(az_sorted, az_cell)
    right = order[pos % len(azimuth)]
    left = order[(pos - 1) % len(azimuth)]
    return left.astype(np.int64), right.astype(np.int64)


def _az_distance_deg(a, b) -> np.ndarray:
    return np.abs((np.asarray(a) - np.asarray(b) + 180.0) % 360.0 - 180.0)


def build_mapping(
    site_lat: float,
    site_lon: float,
    azimuth: np.ndarray,        # (A,) degrees
    range_m: np.ndarray,        # (R,) metres, increasing slant range
    elev_deg: float,
    grid: CartesianGrid,
    *,
    method: str = "nearest",
    power: float = 2.0,
) -> GridMapping:
    """Invert the beam geometry into a gather map, content-cached.

    ``method="nearest"`` keeps the single closest gate (one neighbour,
    unit weight); ``"idw"`` keeps the 2x2 bracketing gates with inverse-
    distance-``power`` weights.  Reach is gate-granular: a cell whose
    ground range falls outside ``[first gate - spacing/2, last gate +
    spacing/2]`` (all via the 4/3-earth model, so reach shrinks with
    elevation) contributes nothing.
    """
    if method not in ("nearest", "idw"):
        raise ValueError(f"unknown method {method!r} (nearest|idw)")
    azimuth = np.asarray(azimuth, np.float64)
    range_m = np.asarray(range_m, np.float64)
    key = _mapping_key(site_lat, site_lon, azimuth, range_m, elev_deg, grid,
                       method, power if method == "idw" else 0.0)
    hit = _cache_get(key)
    if hit is not None:
        return hit

    A, R = len(azimuth), len(range_m)
    lats2d, lons2d = grid.mesh()
    az_cell, s_cell = geometry.latlon_to_polar(site_lat, site_lon,
                                               lats2d.ravel(),
                                               lons2d.ravel())
    gr = np.asarray(geometry.ground_range_m(range_m, elev_deg))  # increasing
    spacing = (gr[-1] - gr[0]) / max(R - 1, 1)
    reach = ((s_cell >= gr[0] - spacing / 2.0)
             & (s_cell <= gr[-1] + spacing / 2.0))

    az_l, az_r = _circular_neighbours(azimuth, az_cell)
    r_hi = np.clip(np.searchsorted(gr, s_cell), 0, R - 1)
    r_lo = np.clip(r_hi - 1, 0, R - 1)

    if method == "nearest":
        d_l = _az_distance_deg(azimuth[az_l], az_cell)
        d_r = _az_distance_deg(azimuth[az_r], az_cell)
        ai = np.where(d_l <= d_r, az_l, az_r)
        ri = np.where(np.abs(gr[r_lo] - s_cell) <= np.abs(gr[r_hi] - s_cell),
                      r_lo, r_hi)
        gate_idx = (ai * R + ri).astype(np.int32)[:, None]
        weights = np.where(reach, 1.0, 0.0).astype(np.float32)[:, None]
    else:  # idw over the 2x2 bracketing gates
        ais = np.stack([az_l, az_l, az_r, az_r], axis=1)     # (C, 4)
        ris = np.stack([r_lo, r_hi, r_lo, r_hi], axis=1)
        g_lat, g_lon = geometry.gate_latlon(
            site_lat, site_lon, azimuth[ais], range_m[ris], elev_deg
        )
        _, d = geometry.latlon_to_polar(
            lats2d.ravel()[:, None], lons2d.ravel()[:, None], g_lat, g_lon
        )
        w = 1.0 / np.maximum(d, 1.0) ** power
        # degenerate brackets (cell before gate 0 / past gate R-1 within
        # the half-spacing tolerance, or A=1) repeat a gate: keep the
        # first occurrence so its weight is not double-counted
        flat = ais * R + ris
        dup = np.zeros_like(w, dtype=bool)
        for j in range(1, flat.shape[1]):
            dup[:, j] = (flat[:, :j] == flat[:, j:j + 1]).any(axis=1)
        w = np.where(dup | ~reach[:, None], 0.0, w)
        gate_idx = flat.astype(np.int32)
        weights = w.astype(np.float32)

    return _cache_put(key, GridMapping(grid, gate_idx, weights, A, R,
                                       method, float(elev_deg)))


# ---------------------------------------------------------------------------
# Gridded products off a store session
# ---------------------------------------------------------------------------


@dataclass
class GridProduct:
    """A Cartesian product: (time, ny, nx) values on a lat/lon grid."""

    values: np.ndarray           # (time, ny, nx) float32, NaN out of reach
    times: np.ndarray            # (time,) epoch seconds
    grid: CartesianGrid
    moment: str
    product: str                 # "cappi" | "column_max" | "ppi"
    params: Dict[str, Any] = field(default_factory=dict)
    chunk_fetches: int = 0       # store chunks fetched to build this

    @property
    def shape(self):
        return self.values.shape

    def composite(self) -> np.ndarray:
        """(ny, nx) max-over-time composite (NaN where never in reach).

        A zero-scan product (a time window that matched no scan) is an
        all-NaN composite, not a reduction error."""
        if self.values.shape[0] == 0:
            return np.full(self.grid.shape, np.nan, np.float32)
        return np.fmax.reduce(self.values, axis=0)


def _flat_gates(block: np.ndarray) -> np.ndarray:
    """(T, ...) -> (T, prod(...)); explicit product so a zero-scan block
    (an empty planner window) flattens instead of tripping reshape(0, -1)."""
    return block.reshape(block.shape[0], int(np.prod(block.shape[1:])))


@dataclass(frozen=True)
class DeviceMap:
    """S gate maps of one grid on a device, stacked to (C, S, k) and in the
    ``grid_map`` kernel's traversal (``kernels.grid_map.cell_order``):
    8 x 8 tiles of the grid one after another, the cells out of every
    sweep's reach last.  What ``ops.grid_map`` takes, with ``order``."""

    gate_idx: torch.Tensor      # (C, S, k) int32, rows in traversal order
    weights: torch.Tensor       # (C, S, k) float32
    order: CellOrder            # the grid cell of each row; the live rows


_DEVICE_MAPS: "OrderedDict[Tuple[Any, ...], DeviceMap]" = OrderedDict()
_DEVICE_MAPS_MAX = 16


def _build_device_map(mappings: Sequence[GridMapping], n_gates: int,
                      device: torch.device) -> DeviceMap:
    gate_idx = np.stack([m.gate_idx for m in mappings], axis=1)  # (C, S, k)
    weights = np.stack([m.weights for m in mappings], axis=1)
    g = mappings[0].grid
    order, n_live = cell_order(gate_idx, weights, n_gates, (g.ny, g.nx))

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return DeviceMap(put(gate_idx[order], np.int32),
                     put(weights[order], np.float32),
                     CellOrder(put(order, np.int32), n_live))


def device_map(mappings: Sequence[GridMapping], n_gates: int,
               device: DeviceLike) -> DeviceMap:
    """The ``grid_map`` kernel's device copy of ``mappings`` (one per
    sweep folded, all on one grid) over a gate axis ``n_gates`` wide,
    cached per (mapping keys, width, device), so a product copies no map
    to the device after its first call.  Mappings built by hand (no cache
    key) are not cached."""
    device = torch.device(device)
    keys = tuple(m.key for m in mappings)
    if not all(keys):
        return _build_device_map(mappings, n_gates, device)
    ck = (keys, int(n_gates), str(device))
    with _MAPPING_LOCK:
        hit = _DEVICE_MAPS.get(ck)
        if hit is not None:
            _DEVICE_MAPS.move_to_end(ck)
            return hit
    built = _build_device_map(mappings, n_gates, device)
    with _MAPPING_LOCK:
        hit = _DEVICE_MAPS.setdefault(ck, built)
        _DEVICE_MAPS.move_to_end(ck)
        while len(_DEVICE_MAPS) > _DEVICE_MAPS_MAX:
            _DEVICE_MAPS.popitem(last=False)
    return hit


def _to_device(block: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host->device copy of a block flattened to (T, gates)."""
    return torch.from_numpy(
        np.ascontiguousarray(_flat_gates(block), np.float32)).to(device)


def _regrid(fields: Sequence[torch.Tensor],
            mappings: Sequence[GridMapping], mode: str) -> torch.Tensor:
    """One ``grid_map`` launch over the sweeps' (T, gates) fields on the
    device (field s through ``mappings[s]``, folded by fmax); the (T, C)
    result stays there."""
    dm = device_map(mappings, fields[0].shape[1], fields[0].device)
    return ops.grid_map(fields, dm.gate_idx, dm.weights, order=dm.order,
                        mode=mode)


def _site_from_root(session: Session) -> Tuple[float, float, float]:
    root = session.group_attrs("")
    return (float(root.get("latitude", 0.0)),
            float(root.get("longitude", 0.0)),
            float(root.get("altitude", 0.0)))


def _sweep_geometry(session: Session, vcp: str, sweeps: Sequence[int]
                    ) -> Tuple[np.ndarray, np.ndarray, List[float]]:
    """Shared (azimuth, range) + per-sweep fixed angles; uniform geometry
    across the used sweeps is required (true for NEXRAD VCPs: each cut
    scans the same radials/gates)."""
    # all sweeps' geometry arrays in one coalesced round trip: the per-
    # sweep loop below then reads from cache instead of serial GETs
    session.prefetch(
        [f"{vcp}/sweep_{si}/{a}" for si in sweeps
         for a in ("azimuth", "range")])
    az = rng = None
    elevs: List[float] = []
    for si in sweeps:
        base = f"{vcp}/sweep_{si}"
        a = session.array(f"{base}/azimuth").read()
        r = session.array(f"{base}/range").read()
        if az is None:
            az, rng = a, r
        elif a.shape != az.shape or r.shape != rng.shape or \
                not (np.array_equal(a, az) and np.array_equal(r, rng)):
            raise ValueError(
                f"sweeps {sweeps} have mixed (azimuth, range) geometry; "
                "grid them separately"
            )
        elevs.append(float(session.group_attrs(base)["fixed_angle"]))
    return az, rng, elevs


def _discover_sweeps(session: Session, vcp: str) -> List[int]:
    prefix = f"{vcp}/sweep_"
    out = []
    for g in session.list_groups():
        if g.startswith(prefix) and "/" not in g[len(prefix):]:
            try:
                out.append(int(g[len(prefix):]))
            except ValueError:
                continue
    if not out:
        raise ValueError(f"no sweeps under {vcp!r}")
    return sorted(out)


def _default_grid(site_lat: float, site_lon: float, rng: np.ndarray,
                  elevs: Sequence[float], ny: int, nx: int) -> CartesianGrid:
    reach = max(float(geometry.ground_range_m(rng[-1], e)) for e in elevs)
    return CartesianGrid.around(site_lat, site_lon, reach, ny, nx)


def _cappi_key(site_lat, site_lon, site_alt, azimuth, range_m, elevs, grid,
               method, altitude_m) -> str:
    return _content_key(
        f"cappi-{method}", [grid.ny, grid.nx],
        [site_lat, site_lon, site_alt, altitude_m],
        list(elevs), azimuth, range_m, _grid_parts(grid),
    )


def _cappi_mapping(site_lat: float, site_lon: float, site_alt: float,
                   az: np.ndarray, rng: np.ndarray, elevs: Sequence[float],
                   grid: CartesianGrid, method: str, altitude_m: float
                   ) -> GridMapping:
    """The CAPPI gather map: per-cell sweep choice (nearest beam height
    to ``altitude_m``, MSL) folded into one map over the sweep-stacked
    gate axis.  Cached like the per-sweep maps."""
    key = _cappi_key(site_lat, site_lon, site_alt, az, rng, elevs, grid,
                     method, altitude_m)
    hit = _cache_get(key)
    if hit is not None:
        return hit

    maps = [build_mapping(site_lat, site_lon, az, rng, e, grid,
                          method=method) for e in elevs]
    # beam height (MSL) each sweep reaches at each cell's ground range
    lats2d, lons2d = grid.mesh()
    _, s_cell = geometry.latlon_to_polar(site_lat, site_lon,
                                         lats2d.ravel(), lons2d.ravel())
    C, G = grid.n_cells, len(az) * len(rng)
    h_err = np.full((len(elevs), C), np.inf)
    for si, e in enumerate(elevs):
        gr = np.asarray(geometry.ground_range_m(rng, e))
        h = np.asarray(geometry.beam_height_m(rng, e, site_alt))
        h_cell = np.interp(s_cell, gr, h)
        h_err[si] = np.where(maps[si].in_reach(),
                             np.abs(h_cell - altitude_m), np.inf)
    chosen = np.argmin(h_err, axis=0)                       # (C,)
    any_reach = np.isfinite(h_err[chosen, np.arange(C)])

    k = maps[0].gate_idx.shape[1]
    gate_idx = np.empty((C, k), np.int32)
    weights = np.zeros((C, k), np.float32)
    for si in range(len(elevs)):
        sel = chosen == si
        gate_idx[sel] = maps[si].gate_idx[sel] + si * G
        weights[sel] = maps[si].weights[sel]
    weights[~any_reach] = 0.0
    return _cache_put(key, GridMapping(grid, gate_idx, weights, len(az),
                                       len(rng), f"cappi-{method}",
                                       float("nan")))


def grid_sweep_from_session(
    session: Session,
    *,
    vcp: str,
    sweep: int,
    moment: str = "DBZH",
    grid: Optional[CartesianGrid] = None,
    time_slice: TimeSliceLike = None,
    method: str = "nearest",
    mode: str = "auto",
    ny: int = 240,
    nx: int = 240,
    device: DeviceLike = None,
) -> GridProduct:
    """Grid one sweep (a Cartesian PPI) straight off the store.

    ``device`` is where the regrid runs: ``None`` means ``"cuda"``, and a
    missing GPU raises unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    site_lat, site_lon, _ = _site_from_root(session)
    az, rng, (elev,) = _sweep_geometry(session, vcp, [sweep])
    if grid is None:
        grid = _default_grid(site_lat, site_lon, rng, [elev], ny, nx)
    mapping = build_mapping(site_lat, site_lon, az, rng, elev, grid,
                            method=method)
    tsl = as_time_slice(time_slice)
    fetches0 = session.cache_stats()["chunk_fetches"]
    # cross-array prefetch: time axis + data block stream in together
    session.prefetch([(f"{vcp}/time", (tsl,)),
                      (f"{vcp}/sweep_{sweep}/{moment}", (tsl,))], wait=False)
    times = session.array(f"{vcp}/time")[tsl]
    block = session.array(f"{vcp}/sweep_{sweep}/{moment}")[tsl]
    out = _regrid([_to_device(block, device)], [mapping], mode)
    return GridProduct(
        out.cpu().numpy().reshape(-1, grid.ny, grid.nx), np.asarray(times),
        grid, moment, "ppi",
        {"vcp": vcp, "sweep": int(sweep), "elevation_deg": elev,
         "method": method},
        session.cache_stats()["chunk_fetches"] - fetches0,
    )


def _cappi_from_session(
    session: Session,
    *,
    vcp: str,
    moment: str = "DBZH",
    altitude_m: float = 2000.0,
    grid: Optional[CartesianGrid] = None,
    sweeps: Optional[Sequence[int]] = None,
    time_slice: TimeSliceLike = None,
    method: str = "nearest",
    mode: str = "auto",
    ny: int = 240,
    nx: int = 240,
    device: DeviceLike = None,
) -> GridProduct:
    # the CAPPI implementation (dispatched via repro_torch.radar.products).
    # Each cell samples the sweep whose beam is closest (in height, MSL)
    # to ``altitude_m`` at that cell's range.  One fused gather over the
    # sweep-stacked block: per-cell sweep choice is folded into the gate
    # map (flat indices offset into the stacked gate axis), so the
    # kernel runs once regardless of sweep count.
    device = resolve_device(device)
    site_lat, site_lon, site_alt = _site_from_root(session)
    sweeps = list(sweeps) if sweeps is not None else \
        _discover_sweeps(session, vcp)
    az, rng, elevs = _sweep_geometry(session, vcp, sweeps)
    if grid is None:
        grid = _default_grid(site_lat, site_lon, rng, elevs, ny, nx)
    mapping = _cappi_mapping(site_lat, site_lon, site_alt, az, rng, elevs,
                             grid, method, altitude_m)

    tsl = as_time_slice(time_slice)
    fetches0 = session.cache_stats()["chunk_fetches"]
    # prefetch every sweep's block (plus the time axis) up front so later
    # sweeps ride earlier batches
    session.prefetch(
        [(f"{vcp}/time", (tsl,))]
        + [(f"{vcp}/sweep_{si}/{moment}", (tsl,)) for si in sweeps],
        wait=False)
    times = session.array(f"{vcp}/time")[tsl]
    blocks = [session.array(f"{vcp}/sweep_{si}/{moment}")[tsl]
              for si in sweeps]
    # the one host copy of the sweep stack, then one device copy of it
    stacked = np.stack(blocks, axis=1)                      # (T, S, A, R)
    del blocks
    out = _regrid([_to_device(stacked, device)], [mapping], mode)
    return GridProduct(
        out.cpu().numpy().reshape(-1, grid.ny, grid.nx), np.asarray(times),
        grid, moment, "cappi",
        {"vcp": vcp, "sweeps": [int(s) for s in sweeps],
         "altitude_m": float(altitude_m), "method": method},
        session.cache_stats()["chunk_fetches"] - fetches0,
    )


def _column_max_from_session(
    session: Session,
    *,
    vcp: str,
    moment: str = "DBZH",
    grid: Optional[CartesianGrid] = None,
    sweeps: Optional[Sequence[int]] = None,
    time_slice: TimeSliceLike = None,
    method: str = "nearest",
    mode: str = "auto",
    ny: int = 240,
    nx: int = 240,
    device: DeviceLike = None,
) -> GridProduct:
    # the column-max implementation (dispatched via
    # repro_torch.radar.products): per cell, the max over all sweeps'
    # regrids (the classic composite-reflectivity product), in one
    # grid_map launch over every sweep's block, the max folded in it.
    device = resolve_device(device)
    site_lat, site_lon, _ = _site_from_root(session)
    sweeps = list(sweeps) if sweeps is not None else \
        _discover_sweeps(session, vcp)
    az, rng, elevs = _sweep_geometry(session, vcp, sweeps)
    if grid is None:
        grid = _default_grid(site_lat, site_lon, rng, elevs, ny, nx)

    tsl = as_time_slice(time_slice)
    fetches0 = session.cache_stats()["chunk_fetches"]
    # readahead for all sweeps at once: sweep i's copy to the device
    # overlaps sweep i+1's fetches
    session.prefetch(
        [(f"{vcp}/time", (tsl,))]
        + [(f"{vcp}/sweep_{si}/{moment}", (tsl,)) for si in sweeps],
        wait=False)
    times = session.array(f"{vcp}/time")[tsl]
    maps = [build_mapping(site_lat, site_lon, az, rng, e, grid,
                          method=method) for e in elevs]
    # each block goes to the device as it is read: no host stack
    fields = [_to_device(session.array(f"{vcp}/sweep_{si}/{moment}")[tsl],
                         device) for si in sweeps]
    out = _regrid(fields, maps, mode).cpu().numpy()
    return GridProduct(
        out.reshape(-1, grid.ny, grid.nx), np.asarray(times), grid, moment,
        "column_max",
        {"vcp": vcp, "sweeps": [int(s) for s in sweeps], "method": method},
        session.cache_stats()["chunk_fetches"] - fetches0,
    )


# ---------------------------------------------------------------------------
# Write-back: products as versioned DataTree nodes
# ---------------------------------------------------------------------------


def product_path(product: GridProduct, name: Optional[str] = None) -> str:
    """Store path a grid product is written under."""
    return f"{PRODUCTS_GROUP}/{name or f'{product.product}_{product.moment}'}"


def write_grid_product(
    repo,
    product: GridProduct,
    *,
    name: Optional[str] = None,
    branch: str = "main",
    message: Optional[str] = None,
    codec: Optional[str] = None,
    time_chunk: int = 16,
) -> str:
    """Commit a gridded product into the archive as an ordinary node.

    The product lands under ``products/<name>`` with CF-ish coordinates
    (``latitude``/``longitude``/``time``) and the provenance recorded as
    group attrs, in one normal transaction.  Re-writing the same name
    replaces the previous version (the old one stays readable via
    history).  Returns the new snapshot id.
    """
    base = product_path(product, name)
    tx = repo.writable_session(branch)
    for apath in tx.list_arrays(f"{base}/"):
        tx.delete_array(apath)
    tx.create_group(base, {
        "product": product.product,
        "moment": product.moment,
        "grid": {"lat_min": product.grid.lat_min,
                 "lat_max": product.grid.lat_max,
                 "lon_min": product.grid.lon_min,
                 "lon_max": product.grid.lon_max,
                 "ny": product.grid.ny, "nx": product.grid.nx},
        "params": product.params,
    })
    T, ny, nx = product.values.shape
    specs = [
        ("time", (T,), "float64", (max(1, min(time_chunk, T)),),
         {"_dims": ["time"], "units": "seconds since 1970-01-01"},
         np.asarray(product.times, np.float64)),
        ("latitude", (ny,), "float64", (ny,),
         {"_dims": ["latitude"], "units": "degrees_north"},
         product.grid.lats()),
        ("longitude", (nx,), "float64", (nx,),
         {"_dims": ["longitude"], "units": "degrees_east"},
         product.grid.lons()),
        (product.moment, (T, ny, nx), "float32",
         (max(1, min(time_chunk, T)), ny, nx),
         {"_dims": ["time", "latitude", "longitude"]},
         np.asarray(product.values, np.float32)),
    ]
    for aname, shape, dtype, chunks, attrs, data in specs:
        arr = tx.create_array(f"{base}/{aname}", shape=shape, dtype=dtype,
                              chunks=chunks, attrs=attrs, codec=codec)
        arr.write_full(data)
    return tx.commit(
        message or f"grid product {base} "
                   f"({T} scans, {ny}x{nx}, {product.params})"
    )


def read_grid_product(session: Session, name: str) -> GridProduct:
    """Re-open a written product as a :class:`GridProduct`.

    Lazy arrays are materialized."""
    base = f"{PRODUCTS_GROUP}/{name}"
    attrs = session.group_attrs(base)
    g = attrs["grid"]
    grid = CartesianGrid(g["lat_min"], g["lat_max"], g["lon_min"],
                         g["lon_max"], int(g["ny"]), int(g["nx"]))
    moment = attrs["moment"]
    return GridProduct(
        values=session.array(f"{base}/{moment}").read(),
        times=session.array(f"{base}/time").read(),
        grid=grid,
        moment=moment,
        product=attrs.get("product", "ppi"),
        params=dict(attrs.get("params", {})),
    )


__all__ = [
    "PRODUCTS_GROUP",
    "CartesianGrid",
    "DeviceMap",
    "GridMapping",
    "GridProduct",
    "build_mapping",
    "clear_mapping_cache",
    "device_map",
    "grid_sweep_from_session",
    "mapping_cache_stats",
    "product_path",
    "read_grid_product",
    "write_grid_product",
]
