"""Unified product-request API: one dataclass, one dispatcher.

A :class:`ProductRequest` names the product and carries every parameter;
:func:`compute_product` dispatches on the request *kind* and the target:
a read session (QVP, QPE, CAPPI, column-max of one archive) or a
:class:`~repro_torch.catalog.Catalog` (federated QVP, QPE and the
multi-site ``mosaic``), each computed on the GPU unless the caller asks
for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

from ._device import DeviceLike, resolve_device
from .grid import _cappi_from_session, _column_max_from_session
from .qpe import _qpe_from_session
from .qvp import _qvp_from_session

#: Product kinds a request may name, in canonical order.
PRODUCT_KINDS: Tuple[str, ...] = ("qvp", "qpe", "cappi", "column_max",
                                  "mosaic")


@dataclass(frozen=True)
class ProductRequest:
    """Every parameter of every radar product, one declarative surface.

    Only ``kind`` is required; the rest default to each product's
    historical defaults, and parameters a product does not consume are
    ignored by its dispatch arm.  The fields are the reference package's,
    so one request replays against either package.  The execution device
    is not a field: like ``workers`` it is a setting of the call.
    """

    kind: str
    moment: str = "DBZH"
    # -- scan selection ------------------------------------------------
    vcp: Optional[str] = None
    sweep: Optional[int] = None              # qvp / qpe (single sweep)
    sweeps: Optional[Tuple[int, ...]] = None  # cappi / column_max subset
    elevation: Optional[float] = None        # catalog sweep-by-elevation
    time_slice: Any = None                   # session targets (planner slice)
    time_between: Optional[Tuple[float, float]] = None  # catalog targets
    within: Any = None                       # catalog spatial predicate
    repos: Optional[Tuple[str, ...]] = None  # catalog repo subset
    # -- gridding ------------------------------------------------------
    grid: Any = None                         # a CartesianGrid of this package
    ny: int = 240
    nx: int = 240
    altitude_m: float = 2000.0
    method: str = "nearest"
    product: str = "column_max"              # mosaic per-site sub-product
    # -- physics knobs -------------------------------------------------
    a: float = 200.0                         # Z-R coefficient (qpe)
    b: float = 1.6                           # Z-R exponent (qpe)
    quality_moment: Optional[str] = "RHOHV"  # qvp quality gate
    quality_min: float = 0.85
    # -- execution -----------------------------------------------------
    mode: str = "auto"                       # kernel dispatch mode
    options: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in PRODUCT_KINDS:
            raise ValueError(
                f"unknown product kind {self.kind!r}; "
                f"known: {list(PRODUCT_KINDS)}"
            )

    def with_options(self, **changes) -> "ProductRequest":
        """A copy of this request with ``changes`` applied."""
        return replace(self, **changes)

    def _require(self, *names: str) -> None:
        missing = [n for n in names if getattr(self, n) is None]
        if missing:
            raise ValueError(
                f"product {self.kind!r} on a session requires "
                f"{missing} in the ProductRequest"
            )


def _is_catalog(target) -> bool:
    # duck-typed, as in the reference: a Catalog opens per-repository
    # sessions and enumerates entries; a Session reads arrays
    return hasattr(target, "open_session") and hasattr(target, "entries")


def _compute_session(session, req: ProductRequest, device):
    if req.kind == "qvp":
        req._require("vcp", "sweep")
        return _qvp_from_session(
            session, vcp=req.vcp, sweep=int(req.sweep), moment=req.moment,
            quality_moment=req.quality_moment, quality_min=req.quality_min,
            time_slice=req.time_slice, mode=req.mode, device=device,
        )
    if req.kind == "qpe":
        req._require("vcp")
        return _qpe_from_session(
            session, vcp=req.vcp,
            sweep=int(req.sweep) if req.sweep is not None else 0,
            moment=req.moment, time_slice=req.time_slice,
            a=req.a, b=req.b, mode=req.mode, device=device,
        )
    if req.kind == "cappi":
        req._require("vcp")
        return _cappi_from_session(
            session, vcp=req.vcp, moment=req.moment,
            altitude_m=req.altitude_m, grid=req.grid, sweeps=req.sweeps,
            time_slice=req.time_slice, method=req.method, mode=req.mode,
            ny=req.ny, nx=req.nx, device=device,
        )
    if req.kind == "column_max":
        req._require("vcp")
        return _column_max_from_session(
            session, vcp=req.vcp, moment=req.moment, grid=req.grid,
            sweeps=req.sweeps, time_slice=req.time_slice,
            method=req.method, mode=req.mode, ny=req.ny, nx=req.nx,
            device=device,
        )
    raise ValueError(
        f"product {req.kind!r} needs a Catalog target, got a session"
    )


def _compute_catalog(catalog, req: ProductRequest, device, *, workers,
                     read_workers):
    # late import: federation imports this module for its own routing
    from ..catalog import federation as fed

    common = dict(moment=req.moment, vcp=req.vcp,
                  time_between=req.time_between, repos=req.repos,
                  mode=req.mode, workers=workers, read_workers=read_workers,
                  device=device)
    if req.kind == "mosaic":
        return fed._federated_mosaic(
            catalog, product=req.product, altitude_m=req.altitude_m,
            grid=req.grid, ny=req.ny, nx=req.nx, sweep=req.sweep,
            elevation=req.elevation, within=req.within, method=req.method,
            **common,
        )
    if req.kind == "qvp":
        return fed.federated_qvp(
            catalog, sweep=req.sweep, elevation=req.elevation,
            quality_moment=req.quality_moment, quality_min=req.quality_min,
            **common,
        )
    if req.kind == "qpe":
        return fed.federated_qpe(
            catalog,
            sweep=int(req.sweep) if req.sweep is not None else 0,
            a=req.a, b=req.b, **common,
        )
    raise ValueError(
        f"product {req.kind!r} has no federated form; open one "
        "repository session and compute it there"
    )


def compute_product(target, request: ProductRequest, *,
                    device: DeviceLike = None,
                    workers: Optional[int] = None, read_workers: int = 1):
    """Compute ``request`` against ``target`` and return its result.

    ``target`` is either a read :class:`~repro_torch.store.Session` (one
    archive; returns ``QVPResult`` / ``QPEResult`` / ``GridProduct``) or a
    :class:`~repro_torch.catalog.Catalog` (the whole federation; returns
    the ``Federated*`` result types, one product per repository computed
    from a pool of ``workers`` threads).  ``device`` is where the products
    are computed: ``None`` means ``"cuda"``, and a missing GPU raises
    ``RuntimeError``, before any session opens, unless the caller passes
    ``device="cpu"``.  ``device``, ``workers`` and ``read_workers`` are
    execution settings and deliberately *not* part of the request: the
    same request replays identically on any executor.
    """
    if not isinstance(request, ProductRequest):
        raise TypeError(
            f"expected a ProductRequest, got {type(request).__name__}"
        )
    dev = resolve_device(device)
    if _is_catalog(target):
        return _compute_catalog(target, request, dev, workers=workers,
                                read_workers=read_workers)
    return _compute_session(target, request, dev)


def request_from_params(kind: str, params: Dict[str, Any]) -> ProductRequest:
    """Build a request from a flat string-keyed parameter dict.

    The adapter the HTTP service uses: unknown keys raise (the service
    validates its own surface first), sequence-valued fields are
    normalized to tuples so requests stay hashable.
    """
    kw: Dict[str, Any] = {}
    for name, value in params.items():
        if name in ("sweeps", "repos") and value is not None and \
                not isinstance(value, tuple):
            value = tuple(value)
        kw[name] = value
    return ProductRequest(kind=kind, **kw)


__all__ = [
    "PRODUCT_KINDS",
    "ProductRequest",
    "compute_product",
    "request_from_params",
]
