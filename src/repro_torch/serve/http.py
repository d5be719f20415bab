"""Archive-as-a-service: the multi-tenant HTTP front of the archive.

The reference package's archive service, kept as this package's copy,
with every product computed by this package on the GPU (or on the CPU
when the service is built with ``device="cpu"``).  It puts the archive
behind plain HTTP so any client — curl, a browser, another language —
can run catalog queries, fetch planner-resolved chunks, and download
finished products without importing anything.

Layering (the ``create_app`` pattern): :class:`ArchiveService` is the
testable service layer — pure methods from parsed parameters to bytes or
JSON-able dicts, no sockets anywhere.  :func:`create_app` turns a
service into an ``http.server`` handler class (routing, ETags, status
codes, content types, and nothing else).  :class:`ArchiveServer` binds
the handler to a bounded worker pool on an ephemeral port.

Because the store is content-addressed, every chunk and product body is
**immutable**: the service exploits that with

* a shared hot-chunk :class:`~repro_torch.serve.scheduling.ByteBudgetCache`
  keyed by content hash (one cache across all tenants — equal hash,
  equal bytes),
* a shared encoded-product cache keyed by the canonical request key,
* strong ETags — the CAS hash itself for ``/chunks/<ref>``, the content
  hash of the body for everything else — honoured via ``If-None-Match``
  / ``304 Not Modified``,
* per-tenant session caches (``X-Tenant`` header) with an LRU slot
  budget, so one tenant's burst cannot evict another's warm sessions,
* :class:`~repro_torch.serve.scheduling.SingleFlight` coalescing on
  products, chunk fetches and session opens: N concurrent identical
  requests run one computation and fan the identical bytes out.

Product bodies are framed by :func:`encode_product` — the reference's
``RPRD`` frame byte for byte: a canonical, deterministic encoding (sorted
canonical-JSON header + C-order array bytes), so a served body is
bitwise-identical to encoding the in-process API's result, and its
header is the reference's for the same request.
"""

from __future__ import annotations

import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..catalog import query as q
from ..catalog.federation import FederatedMosaic
from ..radar._device import DeviceLike, resolve_device
from ..radar.grid import CartesianGrid, GridProduct
from ..radar.products import (PRODUCT_KINDS, compute_product,
                              request_from_params)
from ..radar.qpe import QPEResult
from ..radar.qvp import QVPResult
from ..store.chunks import ChunkGrid, content_hash
from ..store.codecs import json_dumps, json_loads

from .scheduling import ByteBudgetCache, SingleFlight

__all__ = [
    "ApiError", "ArchiveService", "ArchiveServer", "create_app",
    "encode_product", "decode_payload", "PRODUCT_KINDS",
]

DEFAULT_CHUNK_CACHE_BYTES = 32 << 20
DEFAULT_PRODUCT_CACHE_BYTES = 32 << 20
DEFAULT_SESSIONS_PER_TENANT = 8

_MAGIC = b"RPRD"  # payload frame magic: the reference's product/payload v1


class ApiError(Exception):
    """A client-visible failure: HTTP status + plain message."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = int(status)
        self.message = message


# ---------------------------------------------------------------------------
# Canonical payload framing
# ---------------------------------------------------------------------------

def encode_payload(doc: Dict[str, Any],
                   arrays: Dict[str, np.ndarray]) -> bytes:
    """Frame a JSON document plus named arrays into canonical bytes.

    Layout: ``RPRD | u32 header_len | header_json | array bytes...`` with
    the header listing ``arrays`` in sorted-name order (name, dtype,
    shape) and each array appended as C-order raw bytes.  The encoding is
    deterministic — canonical JSON, sorted arrays, fixed byte order — so
    equal results produce equal bytes (the ETag/bitwise contract).
    """
    items = sorted(arrays.items())
    header = json_dumps({
        "doc": doc,
        "arrays": [{"name": name, "dtype": str(a.dtype),
                    "shape": list(a.shape)} for name, a in items],
    })
    parts = [_MAGIC, struct.pack(">I", len(header)), header]
    parts.extend(np.ascontiguousarray(a).tobytes() for _name, a in items)
    return b"".join(parts)


def decode_payload(body: bytes) -> Tuple[Dict[str, Any],
                                         Dict[str, np.ndarray]]:
    """Inverse of :func:`encode_payload` (the client-side half)."""
    if body[:4] != _MAGIC:
        raise ValueError("not a repro payload frame")
    (hlen,) = struct.unpack(">I", body[4:8])
    header = json_loads(body[8:8 + hlen])
    arrays: Dict[str, np.ndarray] = {}
    off = 8 + hlen
    for spec in header["arrays"]:
        dt = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        arrays[spec["name"]] = np.frombuffer(
            body[off:off + n], dtype=dt).reshape(shape)
        off += n
    return header["doc"], arrays


def _grid_doc(grid: CartesianGrid) -> Dict[str, Any]:
    return {"lat_min": grid.lat_min, "lat_max": grid.lat_max,
            "lon_min": grid.lon_min, "lon_max": grid.lon_max,
            "ny": grid.ny, "nx": grid.nx}


def encode_product(result: Any) -> bytes:
    """Canonically encode any product result object to response bytes.

    Cache-state-dependent fields (``chunk_fetches``) are deliberately
    excluded: a served body must be bitwise-identical to encoding the
    same in-process computation regardless of what is warm.
    """
    if isinstance(result, QVPResult):
        return encode_payload(
            {"product": "qvp", "moment": result.moment,
             "elevation_deg": float(result.elevation_deg)},
            {"profile": result.profile, "times": result.times,
             "height_m": result.height_m})
    if isinstance(result, QPEResult):
        return encode_payload(
            {"product": "qpe", "total_hours": float(result.total_hours),
             "n_scans": int(result.n_scans)},
            {"accum_mm": result.accum_mm, "azimuth": result.azimuth,
             "range_m": result.range_m})
    if isinstance(result, GridProduct):
        return encode_payload(
            {"product": result.product, "moment": result.moment,
             "params": result.params, "grid": _grid_doc(result.grid)},
            {"values": result.values, "times": result.times})
    if isinstance(result, FederatedMosaic):
        arrays: Dict[str, np.ndarray] = {"composite": result.composite}
        for repo_id, prod in result.results.items():
            arrays[f"{repo_id}/values"] = prod.values
            arrays[f"{repo_id}/times"] = prod.times
        return encode_payload(
            {"product": result.product, "moment": result.moment,
             "repo_ids": list(result.repo_ids),
             "grid": _grid_doc(result.grid)},
            arrays)
    raise TypeError(f"unencodable product result: {type(result).__name__}")


# ---------------------------------------------------------------------------
# Parameter parsing
# ---------------------------------------------------------------------------

def _one(params: Dict[str, List[str]], name: str) -> Optional[str]:
    vals = params.get(name)
    if not vals:
        return None
    if len(vals) > 1:
        raise ApiError(400, f"duplicate parameter {name!r}")
    return vals[0]

def _typed(params: Dict[str, List[str]], name: str,
           cast: Callable[[str], Any]) -> Optional[Any]:
    raw = _one(params, name)
    if raw is None:
        return None
    try:
        return cast(raw)
    except (TypeError, ValueError):
        raise ApiError(400, f"bad value for {name!r}: {raw!r}") from None


def _require(value: Optional[Any], name: str) -> Any:
    if value is None:
        raise ApiError(400, f"missing required parameter {name!r}")
    return value


def _parse_bool(raw: str) -> bool:
    if raw in ("1", "true", "yes"):
        return True
    if raw in ("0", "false", "no"):
        return False
    raise ValueError(raw)


# ---------------------------------------------------------------------------
# Service layer
# ---------------------------------------------------------------------------

class ArchiveService:
    """The archive behind request-shaped methods (no HTTP in here).

    One instance serves every tenant: chunk and product caches are
    shared (content-addressed data is tenant-independent), sessions are
    cached per tenant with an LRU slot budget.  ``sessions_per_tenant``
    must be at least the number of repositories a tenant touches
    concurrently — an evicted session closes, so a smaller budget only
    costs reopen latency, never correctness of *new* requests.

    ``device`` is where every product is computed, resolved once here:
    ``None`` means ``"cuda"`` and raises ``RuntimeError`` without a GPU
    unless the caller passes ``device="cpu"``.  The kernels then launch
    from the server's worker threads.
    """

    def __init__(self, catalog, *,
                 device: DeviceLike = None,
                 chunk_cache_bytes: int = DEFAULT_CHUNK_CACHE_BYTES,
                 product_cache_bytes: int = DEFAULT_PRODUCT_CACHE_BYTES,
                 sessions_per_tenant: int = DEFAULT_SESSIONS_PER_TENANT,
                 read_workers: int = 1) -> None:
        self.device = resolve_device(device)
        self.catalog = catalog
        self._read_workers = int(read_workers)
        self._sessions_per_tenant = int(sessions_per_tenant)
        self._chunk_cache = ByteBudgetCache(chunk_cache_bytes)
        self._product_cache = ByteBudgetCache(product_cache_bytes)
        self._product_flight = SingleFlight()
        self._chunk_flight = SingleFlight()
        self._session_flight = SingleFlight()
        self._lock = threading.Lock()
        self._tenant_sessions: Dict[str, ByteBudgetCache] = {}

    # -- sessions --------------------------------------------------------
    def _sessions_for(self, tenant: str) -> ByteBudgetCache:
        with self._lock:
            cache = self._tenant_sessions.get(tenant)
            if cache is None:
                cache = ByteBudgetCache(self._sessions_per_tenant)
                self._tenant_sessions[tenant] = cache
            return cache

    def session(self, tenant: str, repo_id: str):
        """A (possibly cached) readonly session on ``repo_id`` for
        ``tenant``.  Concurrent first requests coalesce onto one open;
        LRU eviction closes the displaced session."""
        cache = self._sessions_for(tenant)
        sess = cache.get(repo_id)
        if sess is not None:
            return sess

        def open_() -> Any:
            try:
                s = self.catalog.open_session(
                    repo_id, read_workers=self._read_workers)
            except KeyError:
                raise ApiError(
                    404, f"unknown repository {repo_id!r}") from None
            for _key, old in cache.put(repo_id, s, 1):
                old.close()
            return s

        return self._session_flight.do(("session", tenant, repo_id), open_)

    # -- catalog / query -------------------------------------------------
    def catalog_doc(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for repo_id, entry in sorted(self.catalog.entries().items()):
            t0, t1 = entry.time_range()
            out[repo_id] = {
                "site": entry.site, "branch": entry.branch,
                "snapshot_id": entry.snapshot_id, "bbox": entry.bbox,
                "time_range": [t0, t1], "moments": entry.moments(),
                "vcps": sorted(entry.vcps),
            }
        return {"repositories": out, "products": list(PRODUCT_KINDS)}

    def _predicates(self, params: Dict[str, List[str]]) -> List[Any]:
        preds: List[Any] = []
        t0 = _typed(params, "time0", float)
        t1 = _typed(params, "time1", float)
        if (t0 is None) != (t1 is None):
            raise ApiError(400, "time0 and time1 must be given together")
        if t0 is not None:
            preds.append(q.time_between(t0, t1))
        m = _one(params, "moment")
        if m is not None:
            preds.append(q.moment(*m.split(",")))
        v = _one(params, "vcp")
        if v is not None:
            preds.append(q.vcp(v))
        s = _typed(params, "sweep", int)
        if s is not None:
            preds.append(q.sweep(s))
        site = _one(params, "site")
        if site is not None:
            preds.append(q.site(*site.split(",")))
        elev = _typed(params, "elevation", float)
        if elev is not None:
            preds.append(q.elevation(elev))
        gt = _typed(params, "value_gt", float)
        if gt is not None:
            preds.append(q.value_gt(gt))
        lt = _typed(params, "value_lt", float)
        if lt is not None:
            preds.append(q.value_lt(lt))
        bbox = _one(params, "bbox")
        if bbox is not None:
            parts = bbox.split(",")
            if len(parts) != 4:
                raise ApiError(
                    400, "bbox must be lat_min,lat_max,lon_min,lon_max")
            try:
                preds.append(q.within_box(*(float(p) for p in parts)))
            except ValueError as exc:
                raise ApiError(400, f"bad bbox: {exc}") from None
        return preds

    def run_query(self, params: Dict[str, List[str]],
                  tenant: str = "public") -> Dict[str, Any]:
        """Plan + execute a pruning query on the tenant's cached
        sessions; optionally (``refs=1``) resolve the planner's time
        window to the CAS chunk refs a client would fetch next."""
        preds = self._predicates(params)
        repos_raw = _one(params, "repos")
        repos = repos_raw.split(",") if repos_raw else None
        prune = _typed(params, "prune", _parse_bool)
        prune = True if prune is None else prune
        want_refs = _typed(params, "refs", _parse_bool) or False
        try:
            plan_ = q.plan(self.catalog, *preds, repos=repos)
        except KeyError as exc:
            raise ApiError(404, f"unknown repository {exc}") from None

        scans_doc: List[Dict[str, Any]] = []
        totals = {"n_matches": 0, "n_chunks": 0, "n_read": 0, "n_pruned": 0}
        for repo_id in plan_.repo_ids:
            session = self.session(tenant, repo_id)
            targets = [t for t in plan_.targets if t.repo_id == repo_id]
            for scan in q.run_repo_targets(session, targets, plan_,
                                           prune=prune):
                doc = {
                    "repo": scan.target.repo_id,
                    "vcp": scan.target.vcp,
                    "sweep": scan.target.sweep,
                    "moment": scan.target.moment,
                    "array": scan.target.array_path,
                    "time_bounds": list(scan.time_bounds),
                    "n_matches": int(scan.values.size),
                    "chunks": {"candidates": scan.stats.n_chunks,
                               "read": scan.stats.n_read,
                               "pruned": scan.stats.n_pruned},
                }
                if want_refs:
                    doc["chunk_refs"] = self._window_refs(
                        session, scan.target.array_path, scan.time_bounds)
                scans_doc.append(doc)
                totals["n_matches"] += int(scan.values.size)
                totals["n_chunks"] += scan.stats.n_chunks
                totals["n_read"] += scan.stats.n_read
                totals["n_pruned"] += scan.stats.n_pruned
        pruning_ratio = (totals["n_pruned"] / totals["n_chunks"]
                         if totals["n_chunks"] else 0.0)
        return {"n_matches": totals["n_matches"],
                "chunks_read": totals["n_read"],
                "pruning_ratio": pruning_ratio,
                "scans": scans_doc}

    @staticmethod
    def _window_refs(session, array_path: str,
                     bounds: Tuple[int, int]) -> List[str]:
        """CAS refs of the chunks under ``[i0, i1)`` on the time axis —
        the fetch list a remote client needs after a query."""
        meta = session.array(array_path).meta
        grid = ChunkGrid(tuple(meta.shape), tuple(meta.chunks))
        i0, i1 = bounds
        sel = (slice(max(i0, 0), max(i1, 0)),) + tuple(
            slice(0, s) for s in meta.shape[1:])
        refs: List[str] = []
        for cid in grid.chunks_for_selection(sel):
            ref = session.chunk_ref(array_path, cid)
            if ref is not None:
                refs.append(ref)
        return refs

    # -- chunks ----------------------------------------------------------
    def chunks(self, refs: Sequence[str], repo_id: str,
               tenant: str = "public") -> Dict[str, bytes]:
        """Raw encoded chunk bytes for several CAS refs at once.

        Cache hits are served from the shared hot-chunk cache; all misses
        ride **one** coalesced :meth:`~repro_torch.store.Session.get_blobs`
        round trip against the backend, under a single-flight keyed by
        the miss set (N concurrent identical requests hit the store
        once).  Any unknown ref fails the whole request with a 404.
        """
        refs = list(dict.fromkeys(refs))
        out: Dict[str, bytes] = {}
        missing = []
        for ref in refs:
            cached = self._chunk_cache.get(ref)
            if cached is not None:
                out[ref] = cached
            else:
                missing.append(ref)
        if not missing:
            return out

        def fetch() -> Dict[str, bytes]:
            got: Dict[str, bytes] = {}
            need = []
            for ref in missing:
                blob = self._chunk_cache.get(ref)
                if blob is None:
                    need.append(ref)
                else:
                    got[ref] = blob
            if need:
                session = self.session(tenant, repo_id)
                try:
                    fetched = session.get_blobs(need)
                except KeyError as exc:
                    raise ApiError(
                        404, f"unknown chunk {exc.args[0]!r}") from None
                for ref in need:
                    blob = bytes(fetched[ref])
                    self._chunk_cache.put(ref, blob, len(blob))
                    got[ref] = blob
            return got

        out.update(self._chunk_flight.do(
            ("chunks", tuple(missing)), fetch))
        return out

    def chunk(self, ref: str, repo_id: str,
              tenant: str = "public") -> bytes:
        """Raw encoded chunk bytes for one CAS ref — the single-ref case
        of :meth:`chunks`, sharing its cache and coalesced fetch path."""
        return self.chunks((ref,), repo_id, tenant)[ref]

    # -- products --------------------------------------------------------
    def product(self, kind: str, params: Dict[str, List[str]],
                tenant: str = "public") -> bytes:
        """Encoded product body.  The canonical key (kind + typed,
        sorted parameters) fronts a shared byte-budget cache and a
        single-flight, so identical requests — concurrent or repeated —
        compute at most once until evicted."""
        if kind not in PRODUCT_KINDS:
            raise ApiError(404, f"unknown product {kind!r}; "
                                f"one of {', '.join(PRODUCT_KINDS)}")
        clean = self._product_params(kind, params)
        key = ("product", kind, json_dumps(clean))
        body = self._product_cache.get(key)
        if body is not None:
            return body

        def compute() -> bytes:
            cached = self._product_cache.get(key)
            if cached is not None:
                return cached
            encoded = encode_product(
                self.compute_product(kind, clean, tenant))
            self._product_cache.put(key, encoded, len(encoded))
            return encoded

        return self._product_flight.do(key, compute)

    def _product_params(self, kind: str,
                        params: Dict[str, List[str]]) -> Dict[str, Any]:
        """Parse + normalize request parameters into the canonical typed
        dict that keys the product cache."""
        clean: Dict[str, Any] = {}
        if kind == "mosaic":
            clean["moment"] = _one(params, "moment") or "DBZH"
            clean["product"] = _one(params, "product") or "column_max"
            if clean["product"] not in ("column_max", "cappi"):
                raise ApiError(400, "mosaic product must be "
                                    "column_max or cappi")
            clean["altitude_m"] = _typed(params, "altitude_m",
                                         float) or 2000.0
            clean["ny"] = _typed(params, "ny", int) or 120
            clean["nx"] = _typed(params, "nx", int) or 120
            t0 = _typed(params, "time0", float)
            t1 = _typed(params, "time1", float)
            if (t0 is None) != (t1 is None):
                raise ApiError(400,
                               "time0 and time1 must be given together")
            clean["time_between"] = None if t0 is None else [t0, t1]
            repos = _one(params, "repos")
            clean["repos"] = repos.split(",") if repos else None
            return clean

        clean["repo"] = _require(_one(params, "repo"), "repo")
        clean["vcp"] = _require(_one(params, "vcp"), "vcp")
        clean["moment"] = _one(params, "moment") or "DBZH"
        i0 = _typed(params, "i0", int)
        i1 = _typed(params, "i1", int)
        if (i0 is None) != (i1 is None):
            raise ApiError(400, "i0 and i1 must be given together")
        clean["time_slice"] = None if i0 is None else [i0, i1]
        if kind in ("qvp", "qpe"):
            clean["sweep"] = _typed(params, "sweep", int) or 0
        if kind == "qpe":
            clean["a"] = _typed(params, "a", float) or 200.0
            clean["b"] = _typed(params, "b", float) or 1.6
        if kind in ("cappi", "column_max"):
            clean["ny"] = _typed(params, "ny", int) or 120
            clean["nx"] = _typed(params, "nx", int) or 120
        if kind == "cappi":
            clean["altitude_m"] = _typed(params, "altitude_m",
                                         float) or 2000.0
        return clean

    def _request_for(self, kind: str, clean: Dict[str, Any]):
        """The :class:`~repro_torch.radar.products.ProductRequest` a canonical
        parameter dict denotes — one declarative object per request, so
        the HTTP surface and the in-process API cannot drift."""
        if kind == "mosaic":
            tb = clean["time_between"]
            return request_from_params("mosaic", {
                "moment": clean["moment"], "product": clean["product"],
                "altitude_m": clean["altitude_m"],
                "ny": clean["ny"], "nx": clean["nx"],
                "time_between": tuple(tb) if tb else None,
                "repos": clean["repos"],
            })
        tsl = clean["time_slice"]
        p: Dict[str, Any] = {
            "vcp": clean["vcp"], "moment": clean["moment"],
            "time_slice": tuple(tsl) if tsl else None,
        }
        if kind == "qvp":
            p.update(sweep=clean["sweep"], quality_moment=None)
        elif kind == "qpe":
            p.update(sweep=clean["sweep"], a=clean["a"], b=clean["b"])
        else:  # cappi / column_max
            p.update(ny=clean["ny"], nx=clean["nx"])
            if kind == "cappi":
                p["altitude_m"] = clean["altitude_m"]
        return request_from_params(kind, p)

    def compute_product(self, kind: str, clean: Dict[str, Any],
                        tenant: str = "public") -> Any:
        """Run the unified product API for a parsed parameter dict —
        the exact computation whose encoding a served body must match.

        Everything routes through this package's
        :func:`repro_torch.radar.products.compute_product` on the
        service's device: mosaics against the catalog, the
        single-archive kinds against the tenant's cached session."""
        req = self._request_for(kind, clean)
        if kind == "mosaic":
            return compute_product(self.catalog, req, device=self.device,
                                   read_workers=self._read_workers)
        session = self.session(tenant, clean["repo"])
        try:
            return compute_product(session, req, device=self.device)
        except ApiError:
            raise
        except Exception as exc:
            raise ApiError(
                404, f"product inputs not found: "
                     f"{type(exc).__name__}: {exc}") from None

    # -- watch -----------------------------------------------------------
    def watch(self, params: Dict[str, List[str]]) -> Dict[str, Any]:
        """Long-poll the catalog for branch-head movement (``/watch``).

        ``cursor`` is the JSON head map the previous response returned
        (omit it to bootstrap: every repository reports once,
        immediately); ``timeout_s`` bounds the poll (default 30, capped
        at 300 so a dead client cannot pin a worker).  The response is
        ``{"changes": [...], "cursor": {...}, "timed_out": bool}`` — the
        client re-arms by echoing ``cursor`` back.  Responses are
        time-varying by design, so this route is never cached or
        ETagged.
        """
        raw = _one(params, "cursor")
        cursor: Optional[Dict[str, Any]] = None
        if raw is not None:
            try:
                cursor = json_loads(raw.encode("utf-8"))
            except Exception:
                raise ApiError(400, "cursor must be valid JSON") from None
            if not isinstance(cursor, dict):
                raise ApiError(400, "cursor must be a JSON object")
        timeout_s = _typed(params, "timeout_s", float)
        timeout_s = 30.0 if timeout_s is None else timeout_s
        timeout_s = min(max(timeout_s, 0.0), 300.0)
        poll = _typed(params, "poll_interval_s", float)
        poll = 0.25 if poll is None else min(max(poll, 0.01), timeout_s or 0.25)
        changes, new_cursor = self.catalog.watch(
            cursor, timeout_s=timeout_s, poll_interval_s=poll)
        return {
            "changes": changes,
            "cursor": new_cursor,
            "timed_out": cursor is not None and not changes,
        }

    # -- stats / shutdown ------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            tenants = dict(self._tenant_sessions)
        return {
            "product_flight": self._product_flight.stats(),
            "product_cache": self._product_cache.stats(),
            "chunk_flight": self._chunk_flight.stats(),
            "chunk_cache": self._chunk_cache.stats(),
            "session_flight": self._session_flight.stats(),
            "tenants": {t: c.stats() for t, c in sorted(tenants.items())},
        }

    def close(self) -> None:
        with self._lock:
            caches = list(self._tenant_sessions.values())
        for cache in caches:
            for _repo_id, sess in cache.pop_all():
                sess.close()
        self._chunk_cache.pop_all()
        self._product_cache.pop_all()

    def __enter__(self) -> "ArchiveService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

_TENANT_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-")


def create_app(service: ArchiveService):
    """Bind routing to a service.

    Returns the ``BaseHTTPRequestHandler``
    subclass an ``http.server`` server dispatches to.  All archive logic
    stays on the service; the handler only parses, routes, and speaks
    HTTP (ETags, ``304``, status codes)."""

    class Handler(BaseHTTPRequestHandler):
        server_version = "repro-archive/1"
        protocol_version = "HTTP/1.1"

        def log_message(self, format: str, *args: Any) -> None:
            pass  # the service is library code; no stderr chatter

        # -- response plumbing ------------------------------------------
        def _send(self, status: int, body: bytes, ctype: str,
                  etag: Optional[str] = None) -> None:
            if etag is not None and self._etag_matches(etag):
                self.send_response(304)
                self.send_header("ETag", f'"{etag}"')
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if etag is not None:
                self.send_header("ETag", f'"{etag}"')
                self.send_header("Cache-Control", "max-age=31536000, "
                                                  "immutable")
            self.end_headers()
            self.wfile.write(body)

        def _etag_matches(self, etag: str) -> bool:
            raw = self.headers.get("If-None-Match")
            if raw is None:
                return False
            for cand in raw.split(","):
                cand = cand.strip()
                if cand.startswith("W/"):
                    cand = cand[2:]
                if cand.strip('"') in ("*", etag):
                    return True
            return False

        def _send_json(self, doc: Dict[str, Any], status: int = 200,
                       etag: Optional[str] = None) -> None:
            self._send(status, json_dumps(doc), "application/json",
                       etag=etag)

        def _fail(self, status: int, message: str) -> None:
            self._send(status, json_dumps({"error": message}),
                       "application/json")

        def _tenant(self) -> str:
            tenant = self.headers.get("X-Tenant", "public")
            if not tenant or len(tenant) > 64 or \
                    not set(tenant) <= _TENANT_OK:
                raise ApiError(400, f"bad tenant {tenant!r}")
            return tenant

        # -- routing ----------------------------------------------------
        def do_GET(self) -> None:
            try:
                self._route()
            except ApiError as exc:
                self._fail(exc.status, exc.message)
            except BrokenPipeError:
                pass  # client went away mid-response
            except Exception as exc:  # no raw tracebacks on the wire
                self._fail(500, f"{type(exc).__name__}: {exc}")

        def _route(self) -> None:
            url = urlsplit(self.path)
            parts = [p for p in url.path.split("/") if p]
            params = parse_qs(url.query, keep_blank_values=True)
            tenant = self._tenant()

            if parts == ["catalog"]:
                body = json_dumps(service.catalog_doc())
                self._send(200, body, "application/json",
                           etag=content_hash(body))
            elif parts == ["query"]:
                body = json_dumps(service.run_query(params, tenant))
                self._send(200, body, "application/json",
                           etag=content_hash(body))
            elif parts == ["stats"]:
                self._send_json(service.stats())
            elif parts == ["watch"]:
                self._send_json(service.watch(params))
            elif len(parts) == 2 and parts[0] == "chunks":
                repo = _require(_one(params, "repo"), "repo")
                if "," in parts[1]:
                    # batched form: /chunks/<ref>,<ref>,... — one framed
                    # body, all misses fetched in one coalesced GET
                    refs = [r for r in parts[1].split(",") if r]
                    got = service.chunks(refs, repo, tenant)
                    body = encode_payload(
                        {"chunks": refs},
                        {ref: np.frombuffer(got[ref], dtype=np.uint8)
                         for ref in refs})
                    self._send(200, body, "application/octet-stream",
                               etag=content_hash(body))
                else:
                    blob = service.chunk(parts[1], repo, tenant)
                    self._send(200, blob, "application/octet-stream",
                               etag=parts[1])
            elif len(parts) == 2 and parts[0] == "products":
                body = service.product(parts[1], params, tenant)
                self._send(200, body, "application/octet-stream",
                           etag=content_hash(body))
            else:
                raise ApiError(404, f"no such route {url.path!r}")

    return Handler


class _PooledHTTPServer(HTTPServer):
    """An ``HTTPServer`` dispatching each connection onto a bounded
    worker pool (``ThreadingMixIn`` without the unbounded
    thread-per-request)."""

    daemon_threads = True

    def __init__(self, addr: Tuple[str, int], handler, pool) -> None:
        super().__init__(addr, handler)
        self._pool = pool

    def process_request(self, request, client_address) -> None:
        self._pool.submit(self._handle, request, client_address)

    def _handle(self, request, client_address) -> None:
        try:
            self.finish_request(request, client_address)
        except Exception:
            self.handle_error(request, client_address)
        finally:
            self.shutdown_request(request)


class ArchiveServer:
    """A running archive server.

    Bounded worker pool, ephemeral port by
    default, clean two-phase shutdown (stop accepting, drain workers)."""

    def __init__(self, service: ArchiveService, *, host: str = "127.0.0.1",
                 port: int = 0, workers: int = 8) -> None:
        self.service = service
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="archive-http")
        self._httpd = _PooledHTTPServer((host, port), create_app(service),
                                        self._pool)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ArchiveServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="archive-http-accept", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop the acceptor, drain in-flight handlers, release the
        socket.  Idempotent; does *not* close the service (it may be
        shared across servers)."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join()
            self._thread = None
        self._httpd.server_close()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ArchiveServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()
