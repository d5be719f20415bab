"""Shared selection plumbing for the science workflows.

The catalog query planner resolves a time window to index bounds
``(i0, i1)``; workflows accept that pair anywhere they accept a slice,
so federated execution can stream planner output straight into them.
"""

from __future__ import annotations

from typing import Sequence, Union

TimeSliceLike = Union[None, slice, Sequence[int]]


def as_time_slice(time_slice: TimeSliceLike) -> slice:
    """Normalize ``None`` / ``slice`` / ``(start, stop)`` to a slice."""
    if time_slice is None:
        return slice(None)
    if isinstance(time_slice, slice):
        return time_slice
    start, stop = time_slice
    return slice(int(start), int(stop))
