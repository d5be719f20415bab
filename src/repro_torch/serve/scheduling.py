"""Request scheduling for the serve layer: deterministic FIFO batch plans.

The port's copy of :func:`plan_batches` from the reference package's
``serve/scheduling.py``, which :meth:`repro_torch.serve.engine.Engine.generate`
uses to split a request list into bounded batches.  The reference
module's ``SingleFlight`` and ``ByteBudgetCache`` serve the archive HTTP
service and come with it (ROADMAP, "Modules to port", item 6).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["plan_batches"]


def plan_batches(n_requests: int,
                 max_batch: Optional[int] = None) -> List[Sequence[int]]:
    """Deterministic FIFO batch plan.

    Request indices ``0..n-1`` split
    into contiguous runs of at most ``max_batch`` (one run when
    ``max_batch`` is ``None`` or non-positive).  Order is preserved, so
    stitched results line up with the submitted request list."""
    if n_requests < 0:
        raise ValueError(f"negative request count: {n_requests}")
    if n_requests == 0:
        return []
    if max_batch is None or max_batch <= 0 or max_batch >= n_requests:
        return [range(n_requests)]
    return [range(i, min(i + max_batch, n_requests))
            for i in range(0, n_requests, max_batch)]
