"""Unified product-request API: one dataclass, one dispatcher.

A :class:`ProductRequest` names the product and carries every parameter;
:func:`compute_product` dispatches on the request *kind* and the target.
This package computes the session-target QVP and QPE products on the GPU;
the other kinds and the multi-repository ``Catalog`` target are later
slices of the port (``ROADMAP.md``) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple, Union

import torch

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
    grid: Any = None
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


def _resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "compute_product runs on the GPU and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path "
            "on the CPU"
        )
    return dev


def _compute_session(session, req: ProductRequest, device: torch.device):
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
    if req.kind in ("cappi", "column_max"):
        raise NotImplementedError(
            f"product {req.kind!r} is not ported yet: see ROADMAP.md, "
            "'Modules to port', item 3 (repro_torch.radar.grid and the "
            "grid_map kernel)"
        )
    raise ValueError(
        f"product {req.kind!r} needs a Catalog target, got a session"
    )


def compute_product(target, request: ProductRequest, *,
                    device: Union[None, str, torch.device] = None,
                    workers: Optional[int] = None, read_workers: int = 1):
    """Compute ``request`` against ``target`` and return its result.

    ``target`` is a read :class:`~repro_torch.store.Session` (one archive;
    returns ``QVPResult`` / ``QPEResult``).  ``device`` is where the
    product is computed: ``None`` means ``"cuda"``, and a missing GPU
    raises ``RuntimeError`` unless the caller passes ``device="cpu"``.
    ``device``, ``workers`` and ``read_workers`` are execution settings
    and deliberately *not* part of the request; ``workers`` and
    ``read_workers`` apply to catalog targets, which this package does not
    compute yet.
    """
    if not isinstance(request, ProductRequest):
        raise TypeError(
            f"expected a ProductRequest, got {type(request).__name__}"
        )
    if _is_catalog(target):
        raise NotImplementedError(
            "Catalog targets (federated products) are not ported yet: see "
            "ROADMAP.md, 'Modules to port', item 4 "
            "(repro_torch.catalog.federation)"
        )
    return _compute_session(target, request, _resolve_device(device))


__all__ = [
    "PRODUCT_KINDS",
    "ProductRequest",
    "compute_product",
]
