"""Checkpoints of the training state in the port's versioned store.

The port of the reference package's ``train/checkpoint.py``: a checkpoint
is one atomic commit in a :class:`~repro_torch.store.Repository` (a crash
mid-save leaves the previous checkpoint intact), unchanged tensors
re-reference their content-addressed chunks, ``prune`` drops old steps and
collects their chunks, and ``rollback_to`` moves the branch back to a
known step.  Each leaf is an array under ``<prefix>/step-<step>/<path>``,
its path the reference's (field, key or index of each level: see
:mod:`repro_torch.train.tree`), chunked along the leading dims to about
4 MiB, a bfloat16 leaf stored as its raw uint16 bits, a scalar as shape
(1,): so a checkpoint written by either package restores in the other,
leaf for leaf.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..radar._device import DeviceLike, resolve_device
from ..store import Repository
from ..store.icechunk import NotFound
from .tree import leaves_with_paths, unflatten

# ~4 MiB raw per chunk: large enough to amortize object overhead, small
# enough that a sharded read never over-fetches by more than ~1 chunk
_TARGET_CHUNK_BYTES = 4 << 20
# threads that encode a save's chunks and decode a restore's (the bytes
# and snapshot ids do not depend on it)
_IO_WORKERS = min(8, os.cpu_count() or 1)


def _chunks_for(shape: Tuple[int, ...], itemsize: int) -> Tuple[int, ...]:
    """Chunk along the leading dims until chunks fit the target size."""
    if not shape:
        return (1,)
    chunks = list(shape)
    i = 0
    while i < len(chunks):
        bytes_now = math.prod(chunks) * itemsize
        if bytes_now <= _TARGET_CHUNK_BYTES:
            break
        shrink = math.ceil(bytes_now / _TARGET_CHUNK_BYTES)
        chunks[i] = max(1, chunks[i] // shrink)
        i += 1
    return tuple(chunks)


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """``(array as stored, logical dtype name)``: a bfloat16 tensor as its
    uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _to_tensor(data: np.ndarray, logical: str, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    data = np.array(data)     # contiguous, and a scalar stays 0-d
    if logical == "bfloat16":
        t = torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(data)
    return t.to(device=device, dtype=dtype)


class CheckpointManager:
    """Versioned training-state checkpoints in a repository."""

    def __init__(self, repo: Repository, *, branch: str = "main",
                 prefix: str = "ckpt"):
        self.repo = repo
        self.branch = branch
        self.prefix = prefix

    # -- save ------------------------------------------------------------
    def save(self, step: int, state: Any, *, message: Optional[str] = None,
             extra_attrs: Optional[Dict] = None) -> str:
        """Write one atomic checkpoint commit; returns the snapshot id."""
        tx = self.repo.writable_session(self.branch)
        tx.encode_workers = _IO_WORKERS
        root = f"{self.prefix}/step-{step:010d}"
        tx.create_group(root, attrs={"step": step, **(extra_attrs or {})})
        for name, leaf in leaves_with_paths(state):
            view, logical = _to_numpy(leaf)
            scalar = int(view.ndim == 0)
            if view.ndim == 0:
                view = view.reshape(1)
            a = tx.create_array(
                f"{root}/{name}", shape=view.shape, dtype=view.dtype.name,
                chunks=_chunks_for(view.shape, view.dtype.itemsize),
                attrs={"logical_dtype": logical, "scalar": scalar},
                fill_value=0.0,
            )
            a.write_full(view)
        return tx.commit(message or f"checkpoint step {step}")

    # -- discovery ---------------------------------------------------------
    def steps(self, *, snapshot_id: Optional[str] = None) -> List[int]:
        """The checkpointed steps, oldest first."""
        try:
            sess = self.repo.readonly_session(
                branch=self.branch, snapshot_id=snapshot_id)
        except NotFound:
            return []
        pre = self.prefix + "/step-"
        found = set()
        for g in sess.list_groups():
            if g.startswith(pre) and "/" not in g[len(pre):]:
                found.add(int(g[len(pre):]))
        return sorted(found)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- restore -----------------------------------------------------------
    def restore(self, specs: Any, *, step: Optional[int] = None,
                snapshot_id: Optional[str] = None,
                device: DeviceLike = None, subtree: str = "",
                shardings: Optional[Any] = None, mesh=None) -> Any:
        """Rebuild the state tree shaped like ``specs`` (a tree of
        :class:`~repro_torch.train.step.TensorSpec`, e.g.
        ``train_state_specs(...)``) from checkpoint ``step`` (default the
        newest) on ``device`` (``None`` means ``"cuda"``).  ``subtree``
        restores one part of the state, ``specs`` being that part's
        (``"params"``: the parameters alone, for serving).

        With ``shardings`` (a tree of ``distributed.sharding`` specs
        shaped like ``specs``) and ``mesh``, each leaf becomes a DTensor
        and this rank reads only the chunks under its own shard: the mesh
        may differ from the one that saved (an elastic rescale is another
        set of chunk-aligned partial reads).  A 0-d leaf stays a plain
        tensor."""
        dev = resolve_device(device)
        if step is None:
            ss = self.steps(snapshot_id=snapshot_id)
            if not ss:
                raise NotFound("no checkpoints in repository")
            step = ss[-1]
        root = f"{self.prefix}/step-{step:010d}"
        if subtree:
            root = f"{root}/{subtree}"
        spec_leaves = leaves_with_paths(specs)
        if shardings is None:
            layouts = [None] * len(spec_leaves)
        else:
            from ..distributed.sharding import spec_leaves as _specs
            layouts = _specs(shardings)
        out = []
        with self.repo.readonly_session(
                branch=self.branch, snapshot_id=snapshot_id,
                read_workers=_IO_WORKERS) as sess:
            for (name, spec), layout in zip(spec_leaves, layouts):
                arr = sess.array(f"{root}/{name}")
                logical = arr.attrs.get("logical_dtype", arr.dtype.name)
                region, offset = tuple(slice(None) for _ in spec.shape), None
                if layout is not None and len(spec.shape):
                    from ..distributed.sharding import shard_region
                    region = shard_region(tuple(spec.shape), layout, mesh)
                if arr.attrs.get("scalar", 0):
                    data = arr[(slice(0, 1),)][0]
                else:
                    data = arr[region]
                t = _to_tensor(np.asarray(data), logical, spec.dtype, dev)
                want = tuple(s.stop - s.start if s.stop is not None
                             else n for s, n in zip(region, spec.shape))
                if tuple(t.shape) != want:
                    raise ValueError(f"checkpoint leaf {name}: shape "
                                     f"{tuple(t.shape)}, expected {want}")
                if layout is not None and len(spec.shape):
                    from ..distributed.sharding import as_dtensor
                    t = as_dtensor(t, tuple(spec.shape), layout, mesh)
                out.append(t)
        return unflatten(specs, out)

    # -- lifecycle ---------------------------------------------------------
    def prune(self, keep_last: int = 3) -> List[int]:
        """Drop all but the newest ``keep_last`` checkpoints (one commit),
        then collect unreferenced chunks."""
        steps = self.steps()
        drop = steps[:-keep_last] if keep_last else steps
        if not drop:
            return []
        tx = self.repo.writable_session(self.branch)
        for s in drop:
            root = f"{self.prefix}/step-{s:010d}"
            for path in list(tx.list_arrays(root + "/")):
                tx.delete_array(path)
            tx._doc["groups"].pop(root, None)
        tx.commit(f"prune checkpoints {drop}")
        self.repo.gc()
        return drop

    def rollback_to(self, step: int) -> str:
        """Move the branch back to the latest snapshot containing ``step``
        as its newest checkpoint (divergence recovery)."""
        for info in self.repo.history(self.branch):
            ss = self.steps(snapshot_id=info.snapshot_id)
            if ss and ss[-1] == step:
                self.repo.rollback(self.branch, info.snapshot_id)
                return info.snapshot_id
        raise NotFound(f"no snapshot with newest checkpoint step {step}")
