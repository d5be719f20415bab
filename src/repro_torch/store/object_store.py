"""Local-directory object store with the minimal cloud-store contract.

The archive persists to S3-compatible object storage in deployment; the
transactional layer's read and commit path needs only immutable puts,
reads, batched reads and a *conditional atomic swap* (the compare-and-set
primitive modern object stores expose).  This
:class:`ObjectStore` implements that contract over a local directory, so
the framework runs offline.  The key layout is the reference package's,
so either package opens an archive the other wrote.

Contract:

1. *Atomic puts.*  ``put`` either lands the complete object or nothing —
   it writes a temp file and renames.
2. *Conditional swap.*  ``compare_and_swap`` atomically replaces a small
   mutable object only when its current content equals ``expected``
   (``None`` = "create only if absent").  Branch refs are its only user.
3. *Last-modified times.*  ``put(if_not_exists=True)`` on an existing
   key refreshes its mtime: garbage collection (the reference package's,
   which may sweep an archive this package wrote) keys its grace window
   off it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Sequence


class ObjectStore:
    """Filesystem-backed object store.  Keys are ``/``-separated paths."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        if key.startswith("/") or ".." in key.split("/"):
            raise ValueError(f"invalid object key: {key!r}")
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes, *, if_not_exists: bool = False) -> bool:
        """Atomically write ``data`` under ``key``; True if created.

        With ``if_not_exists`` the put is skipped when the key is already
        present (content-addressed chunks are immutable — identical hash,
        identical bytes), but the object's mtime is refreshed.
        """
        path = self._path(key)
        if if_not_exists and os.path.exists(path):
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

    def exists(self, key: str) -> bool:
        """Whether the key currently resolves to an object."""
        return os.path.exists(self._path(key))

    def get(self, key: str) -> bytes:
        """Read one object; ``KeyError`` when absent."""
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def get_many(self, keys: Sequence[str]) -> Dict[str, bytes]:
        """Fetch several objects (local disk has no round trip to batch)."""
        return {key: self.get(key) for key in keys}

    def compare_and_swap(
        self, key: str, expected: Optional[bytes], new: bytes
    ) -> bool:
        """Atomic conditional update of a (small) mutable object.

        ``expected is None`` means "create only if absent".  The branch
        ref flips from one snapshot id to the next in a single rename
        guarded by an ``O_EXCL`` lock file.  Returns False (no change)
        when the precondition fails or another writer holds the lock.
        """
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lock = path + ".lock"
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        try:
            try:
                with open(path, "rb") as f:
                    current: Optional[bytes] = f.read()
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
