"""Radar DataTree archive: time-resolved FM-301 volumes in the store.

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

Each VCP node carries a leading ``time`` dimension shared by all its
sweeps, extending FM-301 from single volumes to archives.  Appending a
scan is a transactional resize+write.  The layout, chunking and attrs are
the reference package's, so both write identical snapshots.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..store import Repository, Session, Transaction
from . import fm301

DIMS_ATTR = "_dims"  # store-side attribute recording dimension names


class RadarArchive:
    """A time-resolved radar archive bound to an Icechunk repository."""

    TIME_CHUNK = 16         # scans per time chunk
    RANGE_CHUNK = 256       # gates per range chunk

    def __init__(self, repo: Repository, branch: str = "main",
                 codec: Optional[str] = None, *,
                 read_workers: int = 1,
                 cache_bytes: Optional[int] = None,
                 time_chunk: Optional[int] = None):
        self.repo = repo
        self.branch = branch
        # per-array codec for every array this archive creates; None defers
        # to the store default (zlib in every environment)
        self.codec = codec
        if time_chunk is not None and int(time_chunk) < 1:
            raise ValueError(f"time_chunk must be >= 1, got {time_chunk}")
        self.time_chunk = (int(time_chunk) if time_chunk is not None
                           else self.TIME_CHUNK)
        # read-path knobs forwarded to every session this archive opens
        self.read_workers = read_workers
        self.cache_bytes = cache_bytes

    def session(self, **kw) -> Session:
        kw.setdefault("read_workers", self.read_workers)
        if self.cache_bytes is not None:
            kw.setdefault("cache_bytes", self.cache_bytes)
        return self.repo.readonly_session(branch=self.branch, **kw)

    def append_scan(
        self,
        volume: Dict[str, Any],
        *,
        tx: Optional[Transaction] = None,
        commit: bool = True,
    ) -> Optional[str]:
        """Append one decoded FM-301 volume as a transactional update.

        ``volume`` is ``{site, vcp, time, sweeps: [{elevation, azimuth,
        range, moments: {name: (az, gate) float32}}]}``.  Scans of the same
        VCP land in the same subtree, extending its time dimension.  Pass
        ``tx=`` (and ``commit=False``) to batch many scans into one commit,
        so each chunk is encoded once.
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
