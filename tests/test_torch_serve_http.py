"""The port's archive HTTP service against the reference's, on the CPU.

Every case of ``tests/test_serve_http.py`` (and the ``/watch`` cases of
``tests/test_streaming.py``) runs here on ``repro_torch.serve.http``, with
the service built on ``device="cpu"``: substrate, lifecycle, catalog,
query, chunks, product bodies bitwise equal to the port's in-process
encoding, ETag/304, ``computations == unique_requests`` under 8 threads,
tenants, session-budget eviction, 400s, 404s and ``/watch``.  Two
cross-package cases hold the port's served bodies against the
reference's for the same archive and request: the header documents
byte-equal, the arrays within ``tests/test_torch_products.py``'s
tolerances (grids bitwise).

The archives are the reference ETL's (as ``tests/test_serve_http.py``
builds them); the port opens the same directories with its own catalog.
"""

from __future__ import annotations

import http.client
import json
import struct
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.catalog import Catalog as RefCatalog  # noqa: E402
from repro.etl import generate_raw_archive, ingest  # noqa: E402
from repro.serve.http import ArchiveServer as RefServer  # noqa: E402
from repro.serve.http import ArchiveService as RefService  # noqa: E402
from repro.store import ObjectStore as RefObjectStore  # noqa: E402
from repro.store import Repository as RefRepository  # noqa: E402
from repro_torch.catalog import Catalog  # noqa: E402
from repro_torch.catalog import query as q  # noqa: E402
from repro_torch.core import RadarArchive, fm301  # noqa: E402
from repro_torch.etl import StormSimulator  # noqa: E402
from repro_torch.kernels import qvp_reduce  # noqa: E402
from repro_torch.radar import ProductRequest, compute_product  # noqa: E402
from repro_torch.serve.http import (ApiError, ArchiveServer,  # noqa: E402
                                    ArchiveService, decode_payload,
                                    encode_product)
from repro_torch.serve.scheduling import (ByteBudgetCache,  # noqa: E402
                                          SingleFlight, plan_batches)
from repro_torch.store import Repository  # noqa: E402

SITES = ["KVNX", "KTLX"]
VCP = "VCP-212"
QVP_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_torch_products.py
QPE_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_torch_products.py


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve-http")
    ref_catalog = RefCatalog.create(str(base / "catalog"))
    for i, site in enumerate(SITES):
        raw = RefObjectStore(str(base / f"raw-{site}"))
        generate_raw_archive(raw, site_id=site, n_scans=3, n_az=24,
                             n_gates=280, n_sweeps=2, seed=11 + i)
        ingest(raw, RefRepository.create(str(base / f"store-{site}")),
               batch_size=3, time_chunk=2, catalog=ref_catalog,
               repo_id=site)
    repos = {site: Repository.open(str(base / f"store-{site}"))
             for site in SITES}
    return Catalog.open(str(base / "catalog")), repos, ref_catalog


@pytest.fixture(scope="module")
def server(archive):
    catalog, _repos, _ref = archive
    service = ArchiveService(catalog, device="cpu")
    with ArchiveServer(service) as srv:
        yield srv
    service.close()


def _get(server, path, headers=None):
    host, port = server.address
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _header(body: bytes) -> bytes:
    """The canonical-JSON header of an ``RPRD`` frame, as bytes."""
    assert body[:4] == b"RPRD"
    (n,) = struct.unpack(">I", body[4:8])
    return body[8:8 + n]


# -- substrate ---------------------------------------------------------------

def test_plan_batches_shapes():
    assert plan_batches(0) == []
    assert [list(b) for b in plan_batches(5)] == [[0, 1, 2, 3, 4]]
    assert [list(b) for b in plan_batches(5, 2)] == [[0, 1], [2, 3], [4]]
    assert [list(b) for b in plan_batches(4, 9)] == [[0, 1, 2, 3]]
    with pytest.raises(ValueError):
        plan_batches(-1)


def test_single_flight_coalesces_concurrent_calls():
    flight = SingleFlight()
    barrier = threading.Barrier(6)
    calls, results = [], []

    def work():
        calls.append(1)
        time.sleep(0.05)
        return object()

    def run():
        barrier.wait()
        results.append(flight.do("key", work))

    threads = [threading.Thread(target=run) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    stats = flight.stats()
    assert stats["total"] == 6
    assert stats["computations"] == len(calls)
    assert stats["coalesced"] == 6 - len(calls)
    assert len(results) == 6
    # each coalescing group handed every member the same object
    assert len({id(r) for r in results}) == len(calls)


def test_single_flight_propagates_errors():
    flight = SingleFlight()
    with pytest.raises(RuntimeError, match="boom"):
        flight.do("k", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    # the failed flight is retired: a retry computes fresh
    assert flight.do("k", lambda: 7) == 7


def test_byte_budget_cache_evicts_lru():
    cache = ByteBudgetCache(10)
    assert cache.put("a", "A", 4) == []
    assert cache.put("b", "B", 4) == []
    assert cache.get("a") == "A"           # refreshes a
    assert cache.put("c", "C", 4) == [("b", "B")]   # b was LRU
    assert cache.get("b") is None
    stats = cache.stats()
    assert stats["nbytes"] == 8 and stats["entries"] == 2
    assert stats["hits"] == 1 and stats["misses"] == 1
    assert sorted(k for k, _v in cache.pop_all()) == ["a", "c"]
    assert cache.stats()["entries"] == 0


# -- lifecycle ---------------------------------------------------------------

def test_service_resolves_its_device_once_and_refuses_a_missing_gpu(archive):
    catalog, _repos, _ref = archive
    service = ArchiveService(catalog, device="cpu")
    assert service.device == torch.device("cpu")
    service.close()
    if not torch.cuda.is_available():
        # None means "cuda": no GPU, no service (no quiet CPU fall-back)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ArchiveService(catalog)


def test_server_starts_and_stops_on_ephemeral_port(archive):
    catalog, _repos, _ref = archive
    service = ArchiveService(catalog, device="cpu")
    server = ArchiveServer(service).start()
    try:
        assert server.address[1] > 0
        status, _h, body = _get(server, "/catalog")
        assert status == 200 and b"repositories" in body
    finally:
        server.close()
        service.close()
    server.close()  # idempotent


# -- catalog / query ---------------------------------------------------------

def test_catalog_endpoint_lists_repositories(server):
    status, headers, body = _get(server, "/catalog")
    assert status == 200
    assert headers["Content-Type"] == "application/json"
    doc = json.loads(body)
    assert sorted(doc["repositories"]) == sorted(SITES)
    assert "qvp" in doc["products"]


def test_query_endpoint_matches_inprocess(archive, server):
    catalog, _repos, _ref = archive
    status, _h, body = _get(
        server, "/query?moment=DBZH&value_gt=35.0&refs=1")
    assert status == 200
    doc = json.loads(body)
    want = q.query(catalog, q.moment("DBZH"), q.value_gt(35.0))
    assert doc["n_matches"] == want.n_matches
    assert doc["chunks_read"] == want.chunks_read
    assert doc["pruning_ratio"] == pytest.approx(want.pruning_ratio)
    assert any(s["chunk_refs"] for s in doc["scans"])


def test_chunk_endpoint_serves_cas_blobs(archive, server):
    _catalog, repos, _ref = archive
    _s, _h, body = _get(server, "/query?moment=DBZH&refs=1")
    scan = next(s for s in json.loads(body)["scans"] if s["chunk_refs"])
    ref = scan["chunk_refs"][0]
    status, headers, blob = _get(server,
                                 f"/chunks/{ref}?repo={scan['repo']}")
    assert status == 200
    assert headers["ETag"] == f'"{ref}"'
    with repos[scan["repo"]].readonly_session() as session:
        assert blob == bytes(session.get_blob(ref))
    # CAS hash is the strong ETag: revalidation is a 304
    status, _h2, body2 = _get(server, f"/chunks/{ref}?repo={scan['repo']}",
                              headers={"If-None-Match": f'"{ref}"'})
    assert status == 304 and body2 == b""
    # the batched form frames several refs in one body
    refs = scan["chunk_refs"][:2]
    status, _h, framed = _get(
        server, f"/chunks/{','.join(refs)},?repo={scan['repo']}")
    assert status == 200
    doc, arrays = decode_payload(framed)
    assert doc["chunks"] == refs
    with repos[scan["repo"]].readonly_session() as session:
        for r in refs:
            assert arrays[r].tobytes() == bytes(session.get_blob(r))


# -- products: bitwise server-vs-in-process ----------------------------------

PATHS = {
    "qvp": f"/products/qvp?repo=KVNX&vcp={VCP}&sweep=0",
    "qpe": f"/products/qpe?repo=KVNX&vcp={VCP}&sweep=0",
    "cappi": f"/products/cappi?repo=KVNX&vcp={VCP}&ny=40&nx=40",
    "column_max": f"/products/column_max?repo=KVNX&vcp={VCP}&ny=40&nx=40",
    "mosaic": "/products/mosaic?ny=40&nx=40",
}


def _inprocess(catalog, repos):
    """The port's in-process results for PATHS' requests."""
    reqs = {
        "qvp": ProductRequest(kind="qvp", vcp=VCP, sweep=0, moment="DBZH",
                              quality_moment=None),
        "qpe": ProductRequest(kind="qpe", vcp=VCP, sweep=0, moment="DBZH"),
        "cappi": ProductRequest(kind="cappi", vcp=VCP, moment="DBZH",
                                altitude_m=2000.0, ny=40, nx=40),
        "column_max": ProductRequest(kind="column_max", vcp=VCP,
                                     moment="DBZH", ny=40, nx=40),
    }
    with repos["KVNX"].readonly_session() as session:
        out = {k: compute_product(session, r, device="cpu")
               for k, r in reqs.items()}
    out["mosaic"] = compute_product(
        catalog, ProductRequest(kind="mosaic", moment="DBZH",
                                product="column_max", ny=40, nx=40),
        device="cpu")
    return out


def test_product_bodies_bitwise_equal_inprocess(archive, server):
    catalog, repos, _ref = archive
    expected = {k: encode_product(v)
                for k, v in _inprocess(catalog, repos).items()}
    for kind, path in PATHS.items():
        status, headers, body = _get(server, path)
        assert status == 200, (kind, body)
        assert body == expected[kind], (
            f"{kind}: served body != in-process encoding")
        assert headers["ETag"].strip('"')
        doc, arrays = decode_payload(body)
        assert arrays, kind
        assert doc["product"] in (kind, "column_max")


def test_served_bodies_match_the_reference_service(archive, server):
    # the same archive and request through both packages' services: the
    # header documents byte-equal (product, moment, parameters, grid and
    # every array's name, dtype and shape), the arrays within the product
    # tolerances, grids bitwise
    _catalog, _repos, ref_catalog = archive
    ref_service = RefService(ref_catalog)
    try:
        with RefServer(ref_service) as ref_srv:
            for kind, path in PATHS.items():
                status, _h, want = _get(ref_srv, path)
                assert status == 200, (kind, want)
                status, _h, got = _get(server, path)
                assert status == 200, (kind, got)
                assert _header(got) == _header(want), kind
                _doc, ga = decode_payload(got)
                _doc, wa = decode_payload(want)
                assert sorted(ga) == sorted(wa)
                for name in wa:
                    assert ga[name].dtype == wa[name].dtype, (kind, name)
                    if kind == "qvp" and name == "profile":
                        np.testing.assert_allclose(ga[name], wa[name],
                                                   **QVP_TOL)
                    elif kind == "qpe" and name == "accum_mm":
                        np.testing.assert_allclose(ga[name], wa[name],
                                                   **QPE_TOL)
                    else:   # axes, and the grids: bitwise
                        assert ga[name].tobytes() == wa[name].tobytes(), \
                            (kind, name)
    finally:
        ref_service.close()


def test_product_etag_304_roundtrip(server):
    path = PATHS["qvp"]
    _s, headers, _body = _get(server, path)
    etag = headers["ETag"]
    status, h304, body304 = _get(server, path,
                                 headers={"If-None-Match": etag})
    assert status == 304 and body304 == b""
    assert h304["ETag"] == etag
    # a weak validator of the same hash also matches
    status, _h, _b = _get(server, path,
                          headers={"If-None-Match": f"W/{etag}"})
    assert status == 304


# -- coalescing --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["column_max", "qvp"])
def test_concurrent_identical_requests_compute_once(archive, kind):
    catalog, _repos, _ref = archive
    service = ArchiveService(catalog, device="cpu")
    n = 8
    path = (f"/products/column_max?repo=KTLX&vcp={VCP}&ny=32&nx=32"
            if kind == "column_max"
            else f"/products/qvp?repo=KTLX&vcp={VCP}&sweep=1")
    with ArchiveServer(service, workers=n) as srv:
        barrier = threading.Barrier(n)
        bodies = [None] * n
        launches = qvp_reduce.launches

        def hit(i):
            barrier.wait()
            status, _h, body = _get(srv, path)
            assert status == 200
            bodies[i] = body

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

        assert all(b == bodies[0] for b in bodies), \
            "coalesced responses must be bitwise-identical"
        stats = service.stats()
        # one unique request: exactly one computation, regardless of
        # how the n concurrent calls split between coalesce and cache
        assert stats["product_flight"]["computations"] == 1
        total = stats["product_flight"]["total"]
        hits = stats["product_cache"]["hits"]
        assert total + hits == n
        # the plain version on the CPU launches no kernel
        assert qvp_reduce.launches == launches
        # and a repeat is served without a new computation
        _s, _h, again = _get(srv, path)
        assert again == bodies[0]
        assert service.stats()["product_flight"]["computations"] == 1
    service.close()


# -- tenancy -----------------------------------------------------------------

def test_tenants_get_isolated_session_caches(archive):
    catalog, _repos, _ref = archive
    service = ArchiveService(catalog, device="cpu")
    try:
        sa = service.session("tenant-a", "KVNX")
        sb = service.session("tenant-b", "KVNX")
        assert sa is not sb, "tenants must not share sessions"
        assert service.session("tenant-a", "KVNX") is sa, \
            "same tenant re-uses its cached session"
        stats = service.stats()["tenants"]
        assert stats["tenant-a"]["entries"] == 1
        assert stats["tenant-b"]["entries"] == 1
    finally:
        service.close()


def test_tenant_header_routes_to_own_cache(server):
    for tenant in ("acme", "umbrella"):
        status, _h, _b = _get(server, "/catalog",
                              headers={"X-Tenant": tenant})
        assert status == 200
        status, _h, _b = _get(server, "/query?moment=DBZH",
                              headers={"X-Tenant": tenant})
        assert status == 200
    _s, _h, body = _get(server, "/stats")
    tenants = json.loads(body)["tenants"]
    assert "acme" in tenants and "umbrella" in tenants


def test_session_budget_evicts_lru_session(archive):
    catalog, _repos, _ref = archive
    service = ArchiveService(catalog, device="cpu", sessions_per_tenant=1)
    try:
        sa = service.session("t", "KVNX")
        service.session("t", "KTLX")       # evicts (and closes) sa
        assert service.stats()["tenants"]["t"]["entries"] == 1
        assert service.session("t", "KVNX") is not sa
    finally:
        service.close()


# -- malformed requests ------------------------------------------------------

@pytest.mark.parametrize("path,frag", [
    ("/products/qvp", "missing required parameter"),
    ("/products/qvp?repo=KVNX", "missing required parameter"),
    (f"/products/qvp?repo=KVNX&vcp={VCP}&sweep=abc", "bad value"),
    (f"/products/qvp?repo=KVNX&vcp={VCP}&i0=0", "given together"),
    ("/query?time0=1.0", "given together"),
    ("/query?bbox=1,2,3", "bbox"),
    ("/query?prune=maybe", "bad value"),
    ("/query?sweep=0&sweep=1", "duplicate parameter"),
    ("/products/mosaic?product=ppi", "column_max or cappi"),
])
def test_bad_request_is_400_with_message(server, path, frag):
    status, _h, body = _get(server, path)
    assert status == 400, (path, body)
    assert frag.encode() in body


@pytest.mark.parametrize("path", [
    "/nope",
    "/products/sounding?repo=KVNX",
    "/products/qvp?repo=NOPE&vcp=VCP-212",
    "/chunks/deadbeef?repo=KVNX",
])
def test_unknown_things_are_404(server, path):
    status, _h, body = _get(server, path)
    assert status == 404, (path, body)
    assert b"error" in body


def test_bad_tenant_is_400(server):
    status, _h, body = _get(server, "/catalog",
                            headers={"X-Tenant": "bad tenant!"})
    assert status == 400
    assert b"tenant" in body


def test_missing_chunk_repo_param_is_400(server):
    status, _h, _b = _get(server, "/chunks/abc123")
    assert status == 400


def test_api_error_shape():
    err = ApiError(418, "teapot")
    assert err.status == 418 and err.message == "teapot"


# -- the change feed and /watch ----------------------------------------------

N_AZ, N_GATES = 24, 280


def _site_feed(path):
    """A port archive of KVNX scans cut to the test geometry, appended
    one commit per scan by ``append()``."""
    full = fm301.VCPS[VCP]
    vcp = fm301.VCPDef(full.vcp_id, full.elevations[:2], N_AZ, N_GATES,
                       full.gate_m, full.interval_s)
    sim = StormSimulator(seed=3)
    arc = RadarArchive(Repository.create(path))
    count = [0]

    def append():
        arc.append_scan(sim.volume(fm301.SITES["KVNX"], vcp,
                                   1305849600.0 + count[0] * vcp.interval_s))
        count[0] += 1
        return arc.repo.branch_head()

    return arc.repo, append


def test_catalog_poll_changes_cursor_protocol(tmp_path):
    cat = Catalog.create(str(tmp_path / "cat"))
    repo, append = _site_feed(str(tmp_path / "r"))
    append()
    cat.register_repository(repo, repo_id="KVNX")

    changes, cur = cat.poll_changes(None)        # bootstrap: all repos
    assert [c["repo_id"] for c in changes] == ["KVNX"]
    assert changes[0]["prev"] is None
    assert changes[0]["snapshot_id"] == repo.branch_head()

    changes2, cur2 = cat.poll_changes(cur)       # quiescent: nothing
    assert changes2 == [] and cur2 == cur

    head = append()
    changes3, cur3 = cat.poll_changes(cur)
    assert len(changes3) == 1
    assert changes3[0]["prev"] == cur["KVNX"]
    assert changes3[0]["snapshot_id"] == head
    assert cur3["KVNX"] == head
    assert cat.heads() == cur3


def test_catalog_watch_blocks_until_commit(tmp_path):
    cat = Catalog.create(str(tmp_path / "cat"))
    repo, append = _site_feed(str(tmp_path / "r"))
    append()
    cat.register_repository(repo, repo_id="KVNX")
    _, cur = cat.watch(None)                     # bootstrap never blocks

    changes, cur_t = cat.watch(cur, timeout_s=0.15, poll_interval_s=0.02)
    assert changes == [] and cur_t == cur

    t = threading.Thread(target=lambda: (time.sleep(0.2), append()))
    t.start()
    changes, cur2 = cat.watch(cur, timeout_s=30.0, poll_interval_s=0.02)
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(changes) == 1 and changes[0]["repo_id"] == "KVNX"
    assert cur2["KVNX"] == repo.branch_head()


def test_http_watch_endpoint(tmp_path):
    cat = Catalog.create(str(tmp_path / "cat"))
    repo, append = _site_feed(str(tmp_path / "r"))
    append()
    cat.register_repository(repo, repo_id="KVNX")

    with ArchiveService(cat, device="cpu") as svc, \
            ArchiveServer(svc) as srv:
        doc = json.load(urllib.request.urlopen(f"{srv.url}/watch"))
        assert [c["repo_id"] for c in doc["changes"]] == ["KVNX"]
        assert not doc["timed_out"]
        cur_q = urllib.parse.quote(json.dumps(doc["cursor"]))

        quiet = json.load(urllib.request.urlopen(
            f"{srv.url}/watch?cursor={cur_q}&timeout_s=0.1"
            "&poll_interval_s=0.02"))
        assert quiet["changes"] == [] and quiet["timed_out"]

        t = threading.Thread(target=lambda: (time.sleep(0.2), append()))
        t.start()
        woke = json.load(urllib.request.urlopen(
            f"{srv.url}/watch?cursor={cur_q}&timeout_s=30"
            "&poll_interval_s=0.02"))
        t.join(timeout=30)
        assert not t.is_alive()
        assert woke["changes"][0]["snapshot_id"] == repo.branch_head()
        assert woke["cursor"]["KVNX"] == repo.branch_head()

        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{srv.url}/watch?cursor=notjson")
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{srv.url}/watch?cursor=%5B1%5D")
        assert exc.value.code == 400


def test_note_snapshot_and_the_snapshot_hint(tmp_path):
    cat = Catalog.create(str(tmp_path / "cat"))
    repo, append = _site_feed(str(tmp_path / "r"))
    first = append()
    cat.register_repository(repo, repo_id="KVNX")
    head = append()
    assert cat.entry("KVNX").snapshot_id == first
    # a stale hint opens at the head all the same
    with cat.open_session("KVNX") as s:
        assert s.snapshot_id == head
    cat.note_snapshot("KVNX", head)
    assert cat.entry("KVNX").snapshot_id == head
    assert cat.to_doc()["repositories"]["KVNX"]["snapshot_id"] == head
    with cat.open_session("KVNX") as s:
        assert s.snapshot_id == head
    with pytest.raises(KeyError):
        cat.note_snapshot("NOPE", head)
