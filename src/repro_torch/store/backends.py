"""Public import surface for store backends.

A backend is anything
satisfying the :class:`Backend` protocol — ``get``/``put``/``list``/
``delete`` plus the atomic ``compare_and_swap`` the branch-ref commit
protocol builds on.  Two implementations ship in-tree:

* :class:`ObjectStore` — the local-filesystem backend every test and
  example uses (one object per file, CAS via atomic rename).
* :class:`SimulatedLatencyStore` — a wrapper injecting per-operation
  latency/bandwidth models so cloud behaviour (S3-like RTTs, coalesced
  range reads) is reproducible offline; the remote-read measurements and
  the planner-driven prefetch tests run on it.

Custom backends (a real S3 client, say) implement :class:`Backend` and
hand the instance to :class:`repro_torch.store.Repository` — nothing else in
the stack knows the difference.
"""

from __future__ import annotations

from .object_store import Backend, ObjectStore, SimulatedLatencyStore

__all__ = [
    "Backend",
    "ObjectStore",
    "SimulatedLatencyStore",
]
