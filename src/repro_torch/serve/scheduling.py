"""Request-scheduling substrate shared by the serve layer.

The reference package's ``serve/scheduling.py``, kept as this package's
copy.  Three small primitives back both serving surfaces — the archive
HTTP service (:mod:`repro_torch.serve.http`) and the LM engine
(:mod:`repro_torch.serve.engine`):

* :class:`SingleFlight` — request coalescing.  N concurrent calls with
  the same key run the underlying computation exactly once; the leader
  computes, every waiter receives the same object (or the same
  exception).  Because the archive store is content-addressed, any two
  requests with equal keys are guaranteed byte-identical, so coalescing
  is always safe.
* :class:`ByteBudgetCache` — an LRU cache bounded by a byte budget, the
  shape of :class:`repro_torch.store.Session`'s chunk cache generalized
  for hot chunk blobs, encoded product bodies, and (with unit weights)
  per-tenant session slots.  ``put`` returns what it evicted so owners
  holding closable resources can release them outside the lock.
* :func:`plan_batches` — deterministic FIFO batch planning used by
  :meth:`repro_torch.serve.engine.Engine.generate` to split a request
  list into bounded batches without reordering.

Every read and write of guarded state happens under the class's single
``threading.Lock`` — the lock release/acquire pair is also what publishes
a leader's result to its coalesced waiters.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["SingleFlight", "ByteBudgetCache", "plan_batches"]


class _Flight:
    """One in-flight computation: the leader fills ``value``/``error``
    under the owning :class:`SingleFlight` lock, then sets ``done``.
    Waiters block on ``done`` and read the result back under the same
    lock (the release/acquire edge orders the reads after the fill)."""

    __slots__ = ("done", "value", "error", "waiters")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.waiters = 0


class SingleFlight:
    """Coalesce concurrent identical requests onto one computation.

    ``do(key, fn)`` either runs ``fn`` (the *leader* path) or waits for
    the in-flight leader with the same key and returns its result (the
    *coalesced* path).  Keys must be hashable and fully describe the
    computation — the archive service uses canonical request keys, so
    equal keys imply bitwise-equal results.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._inflight: Dict[Any, _Flight] = {}
        self._total = 0          # do() calls
        self._computations = 0   # leader executions (fn actually ran)

    def do(self, key: Any, fn: Callable[[], Any]) -> Any:
        with self._lock:
            self._total += 1
            flight = self._inflight.get(key)
            if flight is None:
                flight = _Flight()
                self._inflight[key] = flight
                self._computations += 1
                leader = True
            else:
                flight.waiters += 1
                leader = False

        if leader:
            try:
                value, error = fn(), None
            except BaseException as exc:  # propagate to every waiter
                value, error = None, exc
            with self._lock:
                flight.value = value
                flight.error = error
                self._inflight.pop(key, None)
            flight.done.set()
            if error is not None:
                raise error
            return value

        flight.done.wait()
        # re-acquiring the leader's lock is the happens-before edge that
        # makes the filled value/error visible (the Event is only a wakeup)
        with self._lock:
            value, error = flight.value, flight.error
        if error is not None:
            raise error
        return value

    def stats(self) -> Dict[str, int]:
        """``total`` calls, leader ``computations``, and ``coalesced``
        (= total - computations: calls served by another call's work)."""
        with self._lock:
            return {
                "total": self._total,
                "computations": self._computations,
                "coalesced": self._total - self._computations,
            }


class ByteBudgetCache:
    """LRU mapping bounded by a byte budget (Session-chunk-cache shape).

    ``put`` weighs each value explicitly (bytes for blobs/bodies, 1 for
    slot-counted caches) and returns the evicted ``(key, value)`` pairs
    so the owner can close evicted resources *outside* the lock.  An
    over-budget single entry is still admitted — the budget bounds the
    steady state, not one oversized value.
    """

    def __init__(self, budget: int) -> None:
        self._lock = threading.Lock()
        self._budget = int(budget)
        self._entries: "OrderedDict[Any, Tuple[Any, int]]" = OrderedDict()
        self._nbytes = 0
        self._hits = 0
        self._misses = 0

    def get(self, key: Any) -> Optional[Any]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return hit[0]

    def put(self, key: Any, value: Any,
            weight: int) -> List[Tuple[Any, Any]]:
        """Insert (or refresh) ``key`` and return evicted pairs."""
        evicted: List[Tuple[Any, Any]] = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._nbytes -= old[1]
            self._entries[key] = (value, int(weight))
            self._nbytes += int(weight)
            while self._nbytes > self._budget and len(self._entries) > 1:
                k, (v, w) = self._entries.popitem(last=False)
                self._nbytes -= w
                evicted.append((k, v))
        return evicted

    def pop_all(self) -> List[Tuple[Any, Any]]:
        """Drain the cache, returning every pair (shutdown path)."""
        with self._lock:
            pairs = [(k, v) for k, (v, _w) in self._entries.items()]
            self._entries.clear()
            self._nbytes = 0
        return pairs

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "nbytes": self._nbytes,
                "budget": self._budget,
                "hits": self._hits,
                "misses": self._misses,
            }


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
