"""The port's catalog and federated products against the reference's, on the CPU.

The three-site federation is built as ``tests/test_catalog.py`` builds it
(the reference ETL registering each ingest in a reference ``Catalog``);
the port opens the same catalog directory with its own
``repro_torch.catalog.Catalog``.  Entries, plans, predicate scans (matches
and chunk accounting) and the federated QVP, QPE and point series must
equal the reference's: QVP and QPE through both packages'
``compute_product`` (the reference in ``mode="ref"`` and with the Pallas
kernels in interpret mode, the port with ``device="cpu"``) at
``tests/test_kernels.py``'s tolerances, the rest exactly.  A catalog
document the port registers must be byte-identical to the reference's.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.catalog import Catalog as RefCatalog  # noqa: E402
from repro.catalog import federated_point_series as ref_point  # noqa: E402
from repro.catalog import query as rq  # noqa: E402
from repro.catalog import scan_repository as ref_scan_repo  # noqa: E402
from repro.etl import generate_raw_archive, ingest  # noqa: E402
from repro.radar.products import ProductRequest as RefRequest  # noqa: E402
from repro.radar.products import compute_product as ref_compute  # noqa: E402
from repro.store import ObjectStore as RefObjectStore  # noqa: E402
from repro.store import Repository as RefRepository  # noqa: E402
from repro_torch.catalog import (Catalog, FederatedQPE,  # noqa: E402
                                 FederatedQVP, federated_point_series,
                                 federated_qvp, federated_scan,
                                 scan_repository)
from repro_torch.catalog import query as tq  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.radar import ProductRequest, compute_product  # noqa: E402
from repro_torch.store import Repository  # noqa: E402

SITES = ["KVNX", "KTLX", "KICT"]
N_SCANS = 3
N_AZ = 24
N_GATES = 520  # 3 range chunks of 256
N_SWEEPS = 2
QVP_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels.py, qvp_reduce
QPE_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py, zr_accum


def _build_site(base, site, *, catalog=None, seed_off=0, n_gates=N_GATES,
                n_scans=N_SCANS):
    raw = RefObjectStore(str(base / f"raw-{site}"))
    generate_raw_archive(raw, site_id=site, n_scans=n_scans, n_az=N_AZ,
                         n_gates=n_gates, n_sweeps=N_SWEEPS,
                         seed=11 + seed_off)
    repo = RefRepository.create(str(base / f"store-{site}"))
    ingest(raw, repo, batch_size=4, catalog=catalog, repo_id=site)
    return repo


@pytest.fixture(scope="module")
def federation(tmp_path_factory):
    base = tmp_path_factory.mktemp("federation")
    ref_cat = RefCatalog.create(str(base / "catalog"))
    for i, site in enumerate(SITES):
        _build_site(base, site, catalog=ref_cat, seed_off=i)
    return base, ref_cat, Catalog.open(str(base / "catalog"))


def _target_key(t):
    return (t.repo_id, t.vcp, t.sweep, t.moment, t.array_path, t.time_path)


def _assert_same_scans(got, want):
    assert len(got.scans) == len(want.scans)
    for sg, sw in zip(got.scans, want.scans):
        assert _target_key(sg.target) == _target_key(sw.target)
        for x, y in zip(sg.coords, sw.coords):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(sg.values, sw.values)
    gs, ws = got.chunk_stats(), want.chunk_stats()
    assert (gs.n_chunks, gs.n_pruned, gs.n_unwritten, gs.n_read) == \
        (ws.n_chunks, ws.n_pruned, ws.n_unwritten, ws.n_read)


# ---------------------------------------------------------------------------
# index and planner
# ---------------------------------------------------------------------------

def test_entries_and_coverage_equal_the_reference(federation):
    base, ref_cat, cat = federation
    assert cat.repository_ids() == ref_cat.repository_ids() == sorted(SITES)
    want = ref_cat.entries()
    for rid, entry in cat.entries().items():
        w = want[rid]
        for field in ("repo_id", "uri", "branch", "snapshot_id", "site",
                      "vcps", "bbox"):
            assert getattr(entry, field) == getattr(w, field), (rid, field)
        assert entry.time_range() == w.time_range()
        assert entry.moments() == w.moments()
        path = str(base / f"store-{rid}")
        assert scan_repository(Repository.open(path)) == \
            ref_scan_repo(RefRepository.open(path))


@pytest.mark.parametrize("preds", [
    lambda q: (q.moment("DBZH"), q.elevation(0.5)),
    lambda q: (q.moment("DBZH", "ZDR"), q.sweep(0)),
    lambda q: (q.moment("DBZH"), q.site("KTLX")),
    lambda q: (q.moment("DBZH"), q.within_box(30.0, 31.0, -91.0, -90.0)),
    lambda q: (q.vcp("VCP-212"), q.moment("RHOHV"), q.sweep(1)),
])
def test_plan_targets_equal_the_reference(federation, preds):
    _, ref_cat, cat = federation
    got = tq.plan(cat, *preds(tq))
    want = rq.plan(ref_cat, *preds(rq))
    assert [_target_key(t) for t in got.targets] == \
        [_target_key(t) for t in want.targets]
    assert got.repo_ids == want.repo_ids


def test_plan_time_windows_equal_the_reference(federation):
    _, ref_cat, cat = federation
    t_lo, t_hi = cat.entry("KVNX").time_range()
    for window in ((t_lo, t_lo + 270.0), (t_hi + 1e6, t_hi + 2e6),
                   (t_lo + 1.0, t_lo + 2.0)):
        got = tq.plan(cat, tq.moment("DBZH"), tq.time_between(*window))
        want = rq.plan(ref_cat, rq.moment("DBZH"), rq.time_between(*window))
        assert [_target_key(t) for t in got.targets] == \
            [_target_key(t) for t in want.targets]


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("workers", [1, 3])
def test_federated_scan_matches_the_reference(federation, prune, workers):
    _, ref_cat, cat = federation
    t_lo, t_hi = cat.entry("KVNX").time_range()
    window = (t_lo, (t_lo + t_hi) / 2)
    got = federated_scan(cat, tq.time_between(*window), tq.moment("DBZH"),
                         tq.value_gt(45.0), prune=prune, workers=workers)
    want = rq.query(ref_cat, rq.time_between(*window), rq.moment("DBZH"),
                    rq.value_gt(45.0), prune=prune)
    _assert_same_scans(got, want)
    assert got.n_matches > 0


@pytest.mark.parametrize("thr, ia, ib, use_lt", [
    (45.0, 0, 2, False), (-20.0, 1, 1, False), (10.0, 2, 0, True),
    (64.0, 0, 1, False), (0.0, 0, 2, True)])
def test_pushdown_property_matches_the_reference(federation, thr, ia, ib,
                                                 use_lt):
    """Pruned equals blind, bitwise, in the port, and both equal the
    reference's pruned query with the same chunk accounting."""
    _, ref_cat, cat = federation
    t_lo, _ = cat.entry("KVNX").time_range()
    ta, tb = sorted((t_lo + 270.0 * ia, t_lo + 270.0 * ib))
    pred = (lambda q: q.value_lt(thr)) if use_lt else \
        (lambda q: q.value_gt(thr))
    pruned = tq.query(cat, tq.time_between(ta, tb), tq.moment("DBZH"),
                      pred(tq))
    blind = tq.query(cat, tq.time_between(ta, tb), tq.moment("DBZH"),
                     pred(tq), prune=False)
    want = rq.query(ref_cat, rq.time_between(ta, tb), rq.moment("DBZH"),
                    pred(rq))
    _assert_same_scans(pruned, want)
    assert len(pruned.scans) == len(blind.scans)
    for a, b in zip(pruned.scans, blind.scans):
        np.testing.assert_array_equal(a.values, b.values)
    assert pruned.chunk_stats().n_read <= blind.chunk_stats().n_read


def test_catalog_document_is_byte_identical(federation, tmp_path):
    base, _, _ = federation
    ref_cat = RefCatalog.create(str(tmp_path / "ref"))
    cat = Catalog.create(str(tmp_path / "port"))
    for site in SITES:
        path = str(base / f"store-{site}")
        ref_cat.register_repository(RefRepository.open(path))
        cat.register_repository(Repository.open(path))
    got = cat.store.get("catalog.json")
    assert got == ref_cat.store.get("catalog.json")
    # and the reference reads what the port wrote
    assert RefCatalog.open(str(tmp_path / "port")).repository_ids() == \
        sorted(SITES)


def test_catalog_open_requires_an_existing_document(tmp_path):
    with pytest.raises(KeyError, match="no catalog document"):
        Catalog.open(str(tmp_path / "nothing"))


# ---------------------------------------------------------------------------
# federated products through both packages' compute_product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_mode", ["ref", "kernel"])
@pytest.mark.parametrize("sweep, window, workers", [
    (1, None, 3), (0, "first two", 1), (0, None, 2)])
def test_federated_qvp_matches_the_reference(federation, jax_mode, sweep,
                                             window, workers):
    _, ref_cat, cat = federation
    t_lo, _ = cat.entry("KVNX").time_range()
    tb = (t_lo, t_lo + 270.0) if window else None
    want = ref_compute(ref_cat, RefRequest(
        kind="qvp", moment="DBZH", sweep=sweep, time_between=tb,
        mode=jax_mode), workers=workers)
    got = compute_product(cat, ProductRequest(
        kind="qvp", moment="DBZH", sweep=sweep, time_between=tb),
        device="cpu", workers=workers)
    assert isinstance(got, FederatedQVP)
    assert got.repo_ids == want.repo_ids == sorted(SITES)
    assert got.profile.shape == want.profile.shape
    if window:
        assert got.profile.shape[0] == 2 * len(SITES)
    np.testing.assert_allclose(got.profile, want.profile, **QVP_TOL)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.height_m, want.height_m)
    for rid in SITES:
        np.testing.assert_allclose(got.results[rid].profile,
                                   want.results[rid].profile, **QVP_TOL)


@pytest.mark.parametrize("jax_mode", ["ref", "kernel"])
@pytest.mark.parametrize("window", [None, "first two"])
def test_federated_qpe_matches_the_reference(federation, jax_mode, window):
    _, ref_cat, cat = federation
    t_lo, _ = cat.entry("KVNX").time_range()
    tb = (t_lo, t_lo + 270.0) if window else None
    want = ref_compute(ref_cat, RefRequest(
        kind="qpe", sweep=0, time_between=tb, mode=jax_mode), workers=3)
    got = compute_product(cat, ProductRequest(kind="qpe", sweep=0,
                                              time_between=tb),
                          device="cpu", workers=3)
    assert isinstance(got, FederatedQPE)
    assert got.repo_ids == want.repo_ids
    assert got.total_scans == want.total_scans
    for rid in SITES:
        g, w = got.results[rid], want.results[rid]
        np.testing.assert_allclose(g.accum_mm, w.accum_mm, **QPE_TOL)
        assert g.n_scans == w.n_scans and g.total_hours == w.total_hours


@pytest.mark.parametrize("az, rng, window", [(45.0, 40_000.0, False),
                                             (359.0, 10_000.0, True)])
def test_federated_point_series_matches_the_reference(federation, az, rng,
                                                      window):
    _, ref_cat, cat = federation
    t_lo, _ = cat.entry("KVNX").time_range()
    tb = (t_lo, t_lo + 270.0) if window else None
    want = ref_point(ref_cat, sweep=0, az_deg=az, range_m=rng,
                     time_between=tb)
    got = federated_point_series(cat, sweep=0, az_deg=az, range_m=rng,
                                 time_between=tb, workers=3)
    assert got.repo_ids == want.repo_ids
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.times, want.times)
    for rid in SITES:
        assert got.results[rid].az_idx == want.results[rid].az_idx
        assert got.results[rid].rng_idx == want.results[rid].rng_idx


def test_ambiguous_and_empty_queries_raise(federation):
    _, _, cat = federation
    with pytest.raises(ValueError, match="ambiguous"):
        federated_qvp(cat, moment="DBZH", device="cpu")  # both sweeps
    with pytest.raises(ValueError, match="matches no repository"):
        compute_product(cat, ProductRequest(kind="qvp", sweep=0,
                                            vcp="VCP-31"), device="cpu")
    with pytest.raises(ValueError, match="no federated form"):
        compute_product(cat, ProductRequest(kind="cappi"), device="cpu")


def test_federated_qvp_rejects_mismatched_geometry(tmp_path):
    ref_cat = RefCatalog.create(str(tmp_path / "catalog"))
    for i, (site, gates) in enumerate((("KVNX", 64), ("KTLX", 96))):
        _build_site(tmp_path, site, catalog=ref_cat, seed_off=i,
                    n_gates=gates, n_scans=1)
    with pytest.raises(ValueError, match="geometry"):
        compute_product(Catalog.open(str(tmp_path / "catalog")),
                        ProductRequest(kind="qvp", sweep=0), device="cpu")


def test_catalog_target_resolves_the_device_before_any_session(
        federation, monkeypatch):
    _, _, cat = federation
    opened = []
    monkeypatch.setattr(cat, "open_session",
                        lambda *a, **k: opened.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("qvp", "qpe", "mosaic"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compute_product(cat, ProductRequest(kind=kind, sweep=0))
    assert opened == []


# ---------------------------------------------------------------------------
# launch counters under the fan-out's threads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module, route", [
    ("repro_torch.kernels.qvp_reduce", None),
    ("repro_torch.kernels.zr_accum", None),
    ("repro_torch.kernels.grid_map", None),
    ("repro_torch.kernels.flash_attention", "tc_prefill"),
    ("repro_torch.kernels.mamba2_scan", "bf16_wide")])
def test_launch_counters_are_exact_under_threads(module, route,
                                                 monkeypatch):
    """Every wrapper counts its launch through ``_cuda.add_launch``; eight
    threads counting 4000 launches each, with the interpreter switching
    threads as often as it can, lose none."""
    mod = sys.modules[module]
    monkeypatch.setattr(mod, "launches", 0)
    if route is not None:
        monkeypatch.setitem(mod.route_launches, route, 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(8)

        def count():
            start.wait()
            for _ in range(4000):
                _cuda.add_launch(module, route)

        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert mod.launches == 8 * 4000
    if route is not None:
        assert mod.route_launches[route] == 8 * 4000
    with open(mod.__file__) as f:
        src = f.read()
    assert src.count("_cuda.add_launch(__name__") == 1
    assert "launches +=" not in src
