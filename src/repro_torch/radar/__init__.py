"""Radar science workflows over the DataTree (paper §5 case studies)."""

from . import geometry
from .products import PRODUCT_KINDS, ProductRequest, compute_product
from .qpe import QPEResult, qpe_from_volumes
from .qvp import QVPResult, qvp_from_volumes

__all__ = [
    "geometry",
    "PRODUCT_KINDS", "ProductRequest", "compute_product",
    "QPEResult", "qpe_from_volumes",
    "QVPResult", "qvp_from_volumes",
]
