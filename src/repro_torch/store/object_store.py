"""Pluggable object-store backends with the minimal cloud-store contract.

The archive persists to S3-compatible object storage in deployment.  This
module defines the :class:`Backend` protocol — the exact API surface the
transactional layer needs (immutable puts, reads, batched reads, listing,
last-modified times, and *conditional atomic swaps*, the compare-and-set
primitive modern object stores expose) — plus two implementations, the
reference package's own, kept as this package's copy with the same key
layout, so either package opens an archive the other wrote:

* :class:`ObjectStore` — a local directory, so the framework runs
  offline.  A real deployment swaps in a GCS or S3 client with the same
  methods.
* :class:`SimulatedLatencyStore` — a deterministic latency/throughput
  model wrapped around any backend: every request pays a fixed
  round-trip time plus ``bytes / bandwidth``, so prefetching and GET
  coalescing are exercised without a network.

**Backend contract** (every implementation must honor all three):

1. *Atomic puts.*  ``put`` either lands the complete object or nothing —
   readers never observe a torn object.  The local backend writes a temp
   file and renames; cloud stores give this for free.
2. *Conditional swap.*  ``compare_and_swap`` atomically replaces a small
   mutable object only when its current content equals ``expected``
   (``None`` = "create only if absent").  It is the single mutable
   primitive in the design; branch refs and the catalog document are the
   only users.
3. *Last-modified times.*  ``mtime`` reports the object's LastModified;
   ``put(if_not_exists=True)`` on an existing key must *refresh* it.
   The gc grace window keys off mtime to protect write-ahead objects
   staged by in-flight commits (see :meth:`ObjectStore.put`).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import (Dict, Iterator, Optional, Protocol, Sequence,
                    runtime_checkable)



@runtime_checkable
class Backend(Protocol):
    """Structural protocol for object-store backends.

    See the module docstring for the three-point contract (atomic puts,
    conditional swap, mtime semantics) every implementation must honor.
    The transactional layer (:class:`repro_torch.store.Repository`) is
    written against exactly these methods and nothing else.
    """

    def put(self, key: str, data: bytes, *,
            if_not_exists: bool = False) -> bool:
        """Atomically write ``data`` under ``key``; True if created."""
        ...

    def get(self, key: str) -> bytes:
        """Return the object's bytes; raise ``KeyError`` when absent."""
        ...

    def get_many(self, keys: Sequence[str]) -> Dict[str, bytes]:
        """Fetch several objects in one batched request.

        Returns ``{key: bytes}`` in input order.  A backend may amortize
        round trips over the batch (one pipelined request instead of
        ``len(keys)`` sequential GETs) — the prefetch plan's coalesced
        fetches rely on this.  Raises ``KeyError`` on the first missing
        key.
        """
        ...

    def exists(self, key: str) -> bool:
        """Whether the key currently resolves to an object."""
        ...

    def mtime(self, key: str) -> float:
        """LastModified (epoch seconds); ``KeyError`` when absent."""
        ...

    def delete(self, key: str) -> None:
        """Remove the object; deleting a missing key is a no-op."""
        ...

    def list(self, prefix: str = "") -> Iterator[str]:
        """Yield every key starting with ``prefix``."""
        ...

    def compare_and_swap(self, key: str, expected: Optional[bytes],
                         new: bytes) -> bool:
        """Atomically replace ``key`` iff its content equals ``expected``."""
        ...


class ObjectStore:
    """Filesystem-backed :class:`Backend`.  Keys are ``/``-separated paths."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    # -- internals ---------------------------------------------------------
    def _path(self, key: str) -> str:
        if key.startswith("/") or ".." in key.split("/"):
            raise ValueError(f"invalid object key: {key!r}")
        return os.path.join(self.root, key)

    # -- public API --------------------------------------------------------
    def put(self, key: str, data: bytes, *, if_not_exists: bool = False) -> bool:
        """Atomically write ``data`` under ``key``.

        Writes to a temp file in the destination directory and renames, so a
        crash mid-put never leaves a torn object (rename is atomic on POSIX
        and object-store puts are atomic by contract).  With
        ``if_not_exists`` the put is skipped when the key is already present
        (content-addressed chunks are immutable — identical hash, identical
        bytes — so skipping is both safe and an important dedup fast path).
        Returns True if this call created the object.
        """
        path = self._path(key)
        if if_not_exists and os.path.exists(path):
            # refresh LastModified even when dedup skips the write: callers
            # use if_not_exists for write-ahead content-addressed objects,
            # and the gc grace window keys off mtime — an old orphaned
            # object being re-staged must look freshly written or a
            # concurrent gc could sweep it out from under an in-flight
            # commit.  (A cloud store would issue the equivalent touch.)
            try:
                os.utime(path)
                return False
            except FileNotFoundError:
                pass  # deleted between exists() and utime(): write below
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True

    def get(self, key: str) -> bytes:
        """Read one object; ``KeyError`` when absent."""
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def get_many(self, keys: Sequence[str]) -> Dict[str, bytes]:
        """Fetch several objects; the local backend just loops ``get``.

        Local disk has no round trip to amortize, so there is nothing to
        coalesce — the method exists so callers can write one batched
        fetch path that a latency-bearing backend accelerates.
        """
        return {key: self.get(key) for key in keys}

    def exists(self, key: str) -> bool:
        """Whether the key currently resolves to an object."""
        return os.path.exists(self._path(key))

    def mtime(self, key: str) -> float:
        """Last-modified time (epoch seconds) of an object.

        Cloud object stores expose this as the LastModified attribute; the
        GC grace window uses it to avoid sweeping objects that an in-flight
        transaction wrote ahead of its commit CAS.
        """
        try:
            return os.stat(self._path(key)).st_mtime
        except FileNotFoundError:
            raise KeyError(key) from None

    def delete(self, key: str) -> None:
        """Remove the object; deleting a missing key is a no-op."""
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def list(self, prefix: str = "") -> Iterator[str]:
        """Yield every key starting with ``prefix`` (temp files skipped)."""
        base = self.root
        start = os.path.join(base, prefix) if prefix else base
        if not os.path.isdir(start):
            # prefix may be a partial filename prefix; walk its parent
            start = os.path.dirname(start) or base
        for dirpath, _dirnames, filenames in os.walk(start):
            for name in filenames:
                if name.startswith(".tmp-"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), base)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    yield key

    def compare_and_swap(
        self, key: str, expected: Optional[bytes], new: bytes
    ) -> bool:
        """Atomic conditional update of a (small) mutable object.

        ``expected is None`` means "create only if absent".  This is the one
        mutable primitive in the design — everything else is immutable — and
        it is what makes commits atomic: the branch ref file flips from one
        snapshot id to the next in a single rename guarded by a lock file.
        Returns False (no change) when the precondition fails.
        """
        return self._cas_locked(key, expected, new)

    def _cas_locked(
        self, key: str, expected: Optional[bytes], new: bytes
    ) -> bool:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lock = path + ".lock"
        # O_EXCL lock file: the loser of a race sees EEXIST and retries/fails.
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        try:
            current: Optional[bytes]
            try:
                with open(path, "rb") as f:
                    current = f.read()
            except FileNotFoundError:
                current = None
            if current != expected:
                return False
            tfd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-")
            with os.fdopen(tfd, "wb") as f:
                f.write(new)
            os.replace(tmp, path)
            return True
        finally:
            os.close(fd)
            os.unlink(lock)


class SimulatedLatencyStore:
    """Deterministic latency/throughput model over any :class:`Backend`.

    Every request against the inner store is charged a fixed round-trip
    time plus ``bytes / bandwidth`` — the two-parameter cost model that
    separates S3-class stores from local disk.  The cost is *pure
    arithmetic over the request* (no wall-clock reads, no randomness),
    so the accumulated :meth:`stats` are bit-identical across machines
    and runs — they are what the remote-read measurements report.  With
    ``sleep=True`` (the default) each charge is also slept, so
    wall-clock measurements against this store behave like a real
    high-latency backend; tests that only assert on request counts pass
    ``sleep=False`` and stay instant.

    A batched :meth:`get_many` pays **one** round trip for the whole
    batch (a pipelined connection) plus bandwidth for the total payload
    — which is exactly why the read path coalesces GETs into per-shard
    batches instead of issuing one request per chunk.

    Correctness semantics (atomicity, CAS, mtime refresh) are entirely
    the inner backend's — this wrapper adds accounting and delay, never
    behavior.
    """

    #: metadata requests (exists/mtime/list/delete/CAS) pay the round
    #: trip but carry no accounted payload
    def __init__(self, inner: Backend, *, rtt_s: float = 0.05,
                 bandwidth_bps: float = 200e6, sleep: bool = True):
        self.inner = inner
        self.rtt_s = float(rtt_s)
        self.bandwidth_bps = float(bandwidth_bps)
        self.sleep = bool(sleep)
        self._stats_lock = threading.Lock()
        self._get_requests = 0      # read round trips (get + get_many calls)
        self._keys_fetched = 0      # objects returned by those round trips
        self._bytes_fetched = 0
        self._put_requests = 0
        self._meta_requests = 0     # exists/mtime/list/delete/CAS round trips
        self._simulated_s = 0.0     # virtual seconds charged (deterministic)

    @property
    def root(self) -> str:
        """The inner backend's root (path-based callers see through us)."""
        return self.inner.root

    # -- cost model --------------------------------------------------------
    def _charge(self, nbytes: int, *, reads: int = 0, keys: int = 0,
                puts: int = 0, metas: int = 0) -> None:
        """Account one request and (optionally) sleep its simulated cost."""
        cost = self.rtt_s + (nbytes / self.bandwidth_bps
                             if self.bandwidth_bps > 0 else 0.0)
        with self._stats_lock:
            self._get_requests += reads
            self._keys_fetched += keys
            self._bytes_fetched += nbytes if reads else 0
            self._put_requests += puts
            self._meta_requests += metas
            self._simulated_s += cost
        if self.sleep and cost > 0.0:
            time.sleep(cost)

    def stats(self) -> Dict[str, float]:
        """Deterministic request accounting since construction.

        ``coalesce_keys_per_get`` is the average number of objects each
        read round trip returned — 1.0 means no batching; higher means
        the prefetch plan's per-shard coalescing is working.
        """
        with self._stats_lock:
            gets = self._get_requests
            return {
                "get_requests": gets,
                "keys_fetched": self._keys_fetched,
                "bytes_fetched": self._bytes_fetched,
                "put_requests": self._put_requests,
                "meta_requests": self._meta_requests,
                "simulated_s": self._simulated_s,
                "coalesce_keys_per_get": (
                    self._keys_fetched / gets if gets else 0.0),
            }

    def reset_stats(self) -> None:
        """Zero the request counters (the virtual clock restarts too)."""
        with self._stats_lock:
            self._get_requests = 0
            self._keys_fetched = 0
            self._bytes_fetched = 0
            self._put_requests = 0
            self._meta_requests = 0
            self._simulated_s = 0.0

    # -- Backend API (delegate + charge) -----------------------------------
    def put(self, key: str, data: bytes, *, if_not_exists: bool = False) -> bool:
        """Inner put, charged one round trip plus upload bandwidth."""
        created = self.inner.put(key, data, if_not_exists=if_not_exists)
        self._charge(len(data), puts=1)
        return created

    def get(self, key: str) -> bytes:
        """Inner get, charged one round trip plus download bandwidth."""
        data = self.inner.get(key)
        self._charge(len(data), reads=1, keys=1)
        return data

    def get_many(self, keys: Sequence[str]) -> Dict[str, bytes]:
        """Batched inner fetch: one round trip for the whole batch.

        This is the coalescing payoff — ``n`` chunks cost ``1 x RTT +
        total_bytes / bandwidth`` instead of ``n x RTT``.
        """
        if not keys:
            return {}
        out = self.inner.get_many(keys)
        self._charge(sum(len(v) for v in out.values()),
                     reads=1, keys=len(out))
        return out

    def exists(self, key: str) -> bool:
        """Inner exists, charged one metadata round trip."""
        found = self.inner.exists(key)
        self._charge(0, metas=1)
        return found

    def mtime(self, key: str) -> float:
        """Inner mtime, charged one metadata round trip."""
        t = self.inner.mtime(key)
        self._charge(0, metas=1)
        return t

    def delete(self, key: str) -> None:
        """Inner delete, charged one metadata round trip."""
        self.inner.delete(key)
        self._charge(0, metas=1)

    def list(self, prefix: str = "") -> Iterator[str]:
        """Inner listing, charged one metadata round trip per call.

        Real stores page LIST responses; one charge per call models the
        common single-page case and keeps the count deterministic.
        """
        self._charge(0, metas=1)
        return self.inner.list(prefix)

    def compare_and_swap(self, key: str, expected: Optional[bytes],
                         new: bytes) -> bool:
        """Inner CAS, charged one metadata round trip.

        Atomicity is the inner backend's; the charge lands after the swap
        so the delay never widens the inner critical section.
        """
        swapped = self.inner.compare_and_swap(key, expected, new)
        self._charge(0, metas=1)
        return swapped
