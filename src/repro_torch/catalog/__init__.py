"""Catalog & query subsystem: the dataset-level layer over repositories.

The reference package's catalog, kept as this package's own copy (the
same catalog document bytes), with the federated products computed by
this package on the GPU.  Three parts (paper FAIR framing, "Findable"
first):

* :mod:`repro_torch.catalog.index` — a canonical-JSON catalog document recording
  which sites/VCPs/moments/time ranges live in which repository, updated
  incrementally by the ETL pipeline;
* :mod:`repro_torch.catalog.query` — a predicate expression API and a planner
  that resolves queries to (repository, array, chunk) read plans, using
  chunk-statistics sidecars for predicate pushdown;
* :mod:`repro_torch.catalog.federation` — fan a plan out across repositories and
  stream the results into the QVP/QPE/time-series workflows.
"""

from . import query
from .federation import (
    FederatedMosaic,
    FederatedPointSeries,
    FederatedQPE,
    FederatedQVP,
    federated_mosaic,
    federated_point_series,
    federated_qpe,
    federated_qvp,
    federated_scan,
)
from .index import Catalog, CatalogEntry, coverage_bbox, scan_repository
from .query import QueryPlan, QueryResult, Target, TargetScan, execute, plan

__all__ = [
    "Catalog",
    "CatalogEntry",
    "FederatedMosaic",
    "FederatedPointSeries",
    "FederatedQPE",
    "FederatedQVP",
    "QueryPlan",
    "QueryResult",
    "Target",
    "TargetScan",
    "coverage_bbox",
    "execute",
    "federated_mosaic",
    "federated_point_series",
    "federated_qpe",
    "federated_qvp",
    "federated_scan",
    "plan",
    "query",
    "scan_repository",
]
