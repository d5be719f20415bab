"""Radar DataTree: the paper's dataset-level data model.

A :class:`DataTree` is a hierarchical container of named variables and
child trees — the same shape as ``xarray.DataTree`` in the paper — with two
properties that matter here:

* **Laziness** — variables may be backed by store arrays; indexing reads
  only the intersecting chunks (the partial-read primitive behind the
  paper's 100× workflows).
* **Time alignment** — each VCP node carries a leading ``time`` dimension
  shared by all its sweeps, extending FM-301 from single volumes to
  archives.  Appending a scan is a transactional resize+write.

Layout in the store (paths mirror Fig. 2 of the paper)::

    <root attrs: site metadata>
    VCP-212/
        time                  (time,)               float64 epoch seconds
        sweep_0/
            azimuth           (azimuth,)            float32 degrees
            range             (range,)              float32 metres
            DBZH              (time, azimuth, range) float32
            ...
        sweep_1/ ...
    VCP-31/ ...

The layout, chunking and attrs are the reference package's, so both write
identical snapshots and each reads the other's archives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..store import Repository, Session, Transaction
from . import fm301

DIMS_ATTR = "_dims"  # store-side attribute recording dimension names


@dataclass
class Variable:
    """Named n-d variable: dims + (lazy or eager) data + CF attrs."""

    dims: Tuple[str, ...]
    data: Any  # np.ndarray | repro_torch.store.Array
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return np.dtype(getattr(self.data, "dtype", np.float32))

    @property
    def lazy(self) -> bool:
        return not isinstance(self.data, np.ndarray)

    def __getitem__(self, key) -> np.ndarray:
        return self.data[key]

    def values(self) -> np.ndarray:
        if isinstance(self.data, np.ndarray):
            return self.data
        return self.data.read()

    def where(
        self,
        selection=None,
        *,
        value_gt: Optional[float] = None,
        value_lt: Optional[float] = None,
        prune: bool = True,
    ):
        """Stat-aware lazy selection: (coords, values) of matching elements.

        A match is a valid (finite, for float dtypes) element inside
        ``selection`` satisfying the value predicates.  Lazy variables push
        the predicate down to the store's chunk-statistics sidecars — chunks
        that provably cannot match are never fetched or decoded (see
        :meth:`repro_torch.store.Array.scan`); eager variables evaluate the same
        predicate in memory.  Match *sets* are identical either way; the
        ordering is deterministic per backend (chunk-major lazy, row-major
        eager).
        """
        if self.lazy:
            res = self.data.scan(selection, value_gt=value_gt,
                                 value_lt=value_lt, prune=prune)
            return res.coords, res.values
        # eager path: one block at offset 0, the same normalization and
        # match definition the chunk scan uses
        from ..store.chunks import (normalize_selection, predicate_mask,
                                    selection_bounds)

        a = np.asarray(self.data)
        sels = normalize_selection(selection, a.ndim)
        bounds = selection_bounds(sels, a.shape)
        mask = predicate_mask(a, [0] * a.ndim, bounds, value_gt, value_lt)
        loc = np.nonzero(mask)
        return tuple(l.astype(np.int64) for l in loc), a[loc]

    def __repr__(self) -> str:
        kind = "lazy" if self.lazy else "eager"
        return f"<Variable {self.dims} {self.shape} {self.dtype} [{kind}]>"


class DataTree:
    """Hierarchical node: variables + attrs + children, path addressable."""

    def __init__(
        self,
        name: str = "",
        variables: Optional[Dict[str, Variable]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.variables: Dict[str, Variable] = dict(variables or {})
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.children: Dict[str, "DataTree"] = {}
        self.parent: Optional["DataTree"] = None

    # -- construction ------------------------------------------------------
    def add_child(self, name: str) -> "DataTree":
        if name not in self.children:
            node = DataTree(name)
            node.parent = self
            self.children[name] = node
        return self.children[name]

    def set_variable(self, name: str, var: Variable) -> None:
        self.variables[name] = var

    # -- navigation ----------------------------------------------------
    def __getitem__(self, path: str) -> Union["DataTree", Variable]:
        """Path-style access: ``tree["VCP-212/sweep_0/DBZH"]`` (Fig. 2)."""
        node: DataTree = self
        parts = [p for p in path.strip("/").split("/") if p]
        for i, part in enumerate(parts):
            if part in node.children:
                node = node.children[part]
            elif part in node.variables and i == len(parts) - 1:
                return node.variables[part]
            else:
                raise KeyError(f"{path!r} (missing {part!r})")
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
            return True
        except KeyError:
            return False

    def subtree(self) -> Iterator[Tuple[str, "DataTree"]]:
        """Yield (path, node) depth-first, root first."""
        stack: List[Tuple[str, DataTree]] = [("", self)]
        while stack:
            path, node = stack.pop()
            yield path, node
            for name in sorted(node.children, reverse=True):
                child = node.children[name]
                stack.append((f"{path}/{name}".strip("/"), child))

    @property
    def path(self) -> str:
        parts = []
        node: Optional[DataTree] = self
        while node is not None and node.name:
            parts.append(node.name)
            node = node.parent
        return "/".join(reversed(parts))

    def __repr__(self) -> str:
        lines = [f"<DataTree {self.name or '/'!r}>"]
        for path, node in self.subtree():
            indent = "  " * (path.count("/") + (1 if path else 0))
            if path:
                lines.append(f"{indent}{path.rsplit('/', 1)[-1]}/")
            for vname, var in node.variables.items():
                lines.append(f"{indent}  {vname} {var.dims} {var.shape}")
        return "\n".join(lines[:60])


# ---------------------------------------------------------------------------
# Archive view: DataTree <-> transactional store
# ---------------------------------------------------------------------------

class RadarArchive:
    """A time-resolved radar archive bound to an Icechunk repository."""

    TIME_CHUNK = 16         # scans per time chunk
    RANGE_CHUNK = 256       # gates per range chunk (aligned with kernel tiles)

    def __init__(self, repo: Repository, branch: str = "main",
                 codec: Optional[str] = None, *,
                 read_workers: int = 1,
                 cache_bytes: Optional[int] = None,
                 time_chunk: Optional[int] = None):
        self.repo = repo
        self.branch = branch
        # per-array codec for every array this archive creates; None defers
        # to the store default (zlib in every environment — deterministic
        # snapshot ids; pass codec="zstd" explicitly for the fast path)
        self.codec = codec
        # scans per time chunk for newly created arrays.  A live feed
        # appending scan-by-scan may set this low (cheap RMW appends) and
        # rely on the compaction maintenance pass
        # (repro_torch.store.compaction) to merge the fragments into
        # analysis-ready chunks later.
        if time_chunk is not None and int(time_chunk) < 1:
            raise ValueError(f"time_chunk must be >= 1, got {time_chunk}")
        self.time_chunk = (int(time_chunk) if time_chunk is not None
                           else self.TIME_CHUNK)
        # read-path knobs forwarded to every session this archive opens:
        # a reader thread pool for multi-chunk selections and the decoded-
        # chunk LRU budget (None -> store default)
        self.read_workers = read_workers
        self.cache_bytes = cache_bytes

    def _session_kw(self, kw: Dict[str, Any]) -> Dict[str, Any]:
        kw.setdefault("read_workers", self.read_workers)
        if self.cache_bytes is not None:
            kw.setdefault("cache_bytes", self.cache_bytes)
        return kw

    # -- reading ---------------------------------------------------------
    def tree(self, *, snapshot_id: Optional[str] = None,
             tag: Optional[str] = None) -> DataTree:
        """Open the archive as a lazy DataTree (one object, Fig. 2 style)."""
        session = self.repo.readonly_session(
            branch=self.branch, snapshot_id=snapshot_id, tag=tag,
            **self._session_kw({}),
        )
        return tree_from_session(session)

    def session(self, **kw) -> Session:
        return self.repo.readonly_session(branch=self.branch,
                                          **self._session_kw(kw))

    # -- writing -----------------------------------------------------------
    def append_scan(
        self,
        volume: Dict[str, Any],
        *,
        tx: Optional[Transaction] = None,
        commit: bool = True,
    ) -> Optional[str]:
        """Append one decoded FM-301 volume as a transactional update.

        ``volume`` is the decoder output: ``{site, vcp, time, sweeps: [
        {elevation, azimuth, range, moments: {name: (az, gate) float32}}]}``.
        Scans of the same VCP land in the same subtree, extending its time
        dimension (ragged across VCPs, exactly like the paper's KVNX May
        2011 example where the site switches VCP mid-month).
        """
        own_tx = tx is None
        if tx is None:
            tx = self.repo.writable_session(self.branch)
        vcp: fm301.VCPDef = volume["vcp"]
        site: fm301.RadarSite = volume["site"]
        base = vcp.name
        tx.update_group_attrs("", site.root_attrs())

        t_path = f"{base}/time"
        if not tx.has_array(t_path):
            tx.create_group(base, {"vcp_id": vcp.vcp_id,
                                   "interval_s": vcp.interval_s})
            tx.create_array(
                t_path, shape=(0,), dtype="float64",
                chunks=(self.time_chunk,),
                attrs={DIMS_ATTR: ["time"], "units": "seconds since 1970-01-01",
                       "standard_name": "time"},
                codec=self.codec,
            )
        t_arr = tx.array(t_path)
        n_time = t_arr.shape[0]
        t_arr = tx.resize_array(t_path, (n_time + 1,))
        t_arr[n_time] = np.float64(volume["time"])

        for si, sweep in enumerate(volume["sweeps"]):
            g = f"{base}/{fm301.sweep_group_name(si)}"
            n_az = len(sweep["azimuth"])
            n_rg = len(sweep["range"])
            if not tx.has_array(f"{g}/azimuth"):
                tx.create_group(g, fm301.sweep_attrs(vcp, si))
                az = tx.create_array(
                    f"{g}/azimuth", shape=(n_az,), dtype="float32",
                    chunks=(n_az,),
                    attrs={DIMS_ATTR: ["azimuth"], "units": "degrees"},
                    codec=self.codec,
                )
                az.write_full(sweep["azimuth"].astype("float32"))
                rg = tx.create_array(
                    f"{g}/range", shape=(n_rg,), dtype="float32",
                    chunks=(n_rg,),
                    attrs={DIMS_ATTR: ["range"], "units": "meters",
                           "meters_between_gates": vcp.gate_m},
                    codec=self.codec,
                )
                rg.write_full(sweep["range"].astype("float32"))
            for mname, mdata in sweep["moments"].items():
                apath = f"{g}/{mname}"
                if not tx.has_array(apath):
                    tx.create_array(
                        apath,
                        shape=(0, n_az, n_rg),
                        dtype="float32",
                        chunks=(self.time_chunk, n_az,
                                min(self.RANGE_CHUNK, n_rg)),
                        attrs={DIMS_ATTR: ["time", "azimuth", "range"],
                               **fm301.MOMENTS.get(mname, {})},
                        codec=self.codec,
                    )
                arr = tx.resize_array(apath, (n_time + 1, n_az, n_rg))
                arr[n_time] = np.asarray(mdata, dtype="float32")

        if own_tx and commit:
            return tx.commit(
                f"append {vcp.name} scan t={volume['time']:.0f} "
                f"site={site.site_id}"
            )
        return None


def tree_from_session(session: Session) -> DataTree:
    """Materialize the hierarchy (lazily) from a store session."""
    root = DataTree("", attrs=dict(session.group_attrs("")))
    for gpath in session.list_groups():
        if not gpath:
            continue
        node = root
        for part in gpath.split("/"):
            node = node.add_child(part)
        node.attrs.update(session.group_attrs(gpath))
    for apath in session.list_arrays():
        parts = apath.split("/")
        node = root
        for part in parts[:-1]:
            node = node.add_child(part)
        arr = session.array(apath)
        dims = tuple(arr.attrs.get(DIMS_ATTR, [f"dim_{i}" for i in
                                               range(len(arr.shape))]))
        node.set_variable(parts[-1], Variable(dims, arr, dict(arr.attrs)))
    return root
