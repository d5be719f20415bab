"""Radar science workflows over the DataTree (paper §5 case studies)."""

from . import geometry
from .grid import (CartesianGrid, GridMapping, GridProduct, build_mapping,
                   grid_sweep_from_session, read_grid_product,
                   write_grid_product)
from .incremental import (IncrementalGridProduct, IncrementalMosaic,
                          IncrementalQPE, MosaicState, UpdateReport,
                          incremental_product, streaming_qpe)
from .products import (PRODUCT_KINDS, ProductRequest, compute_product,
                       request_from_params)
from .qpe import QPEResult, qpe_from_volumes
from .qvp import QVPResult, qvp_from_volumes
from .timeseries import PointSeries, point_series_from_session

__all__ = [
    "geometry",
    "CartesianGrid", "GridMapping", "GridProduct", "build_mapping",
    "grid_sweep_from_session", "read_grid_product", "write_grid_product",
    "IncrementalGridProduct", "IncrementalMosaic", "IncrementalQPE",
    "MosaicState",
    "UpdateReport", "incremental_product", "streaming_qpe",
    "PRODUCT_KINDS", "ProductRequest", "compute_product",
    "request_from_params",
    "QPEResult", "qpe_from_volumes",
    "QVPResult", "qvp_from_volumes",
    "PointSeries", "point_series_from_session",
]
