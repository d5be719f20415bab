"""The port's federated mosaic and incremental mosaic against the reference's.

Follows ``tests/test_grid.py``'s federated-mosaic tests and
``tests/test_streaming.py``'s incremental mosaic, on the CPU: three sites
built with the reference ETL into one reference ``Catalog``, opened by the
port's own ``Catalog``.  Column-max and CAPPI mosaics through both
packages' ``compute_product`` are **bitwise** equal (the reference in
``mode="ref"`` and with the Pallas ``grid_map`` in interpret mode), with
equal chunk fetches under a time window, the same bbox pruning and an
all-NaN composite on an empty window.  The incremental mosaic runs on two
copies of a two-site federation, one per package: after appended scans
its state equals its own from-scratch mosaic and the reference's state,
bit for bit.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.catalog import Catalog as RefCatalog  # noqa: E402
from repro.core import RadarArchive as RefArchive  # noqa: E402
from repro.core import fm301 as ref_fm301  # noqa: E402
from repro.etl import StormSimulator as RefSimulator  # noqa: E402
from repro.etl import generate_raw_archive, ingest  # noqa: E402
from repro.radar import incremental_product as ref_incremental  # noqa: E402
from repro.radar.products import ProductRequest as RefRequest  # noqa: E402
from repro.radar.products import compute_product as ref_compute  # noqa: E402
from repro.store import ObjectStore as RefObjectStore  # noqa: E402
from repro.store import Repository as RefRepository  # noqa: E402
from repro_torch.catalog import Catalog, FederatedMosaic  # noqa: E402
from repro_torch.catalog import federation  # noqa: E402
from repro_torch.core import RadarArchive, fm301  # noqa: E402
from repro_torch.etl import StormSimulator  # noqa: E402
from repro_torch.radar import (IncrementalMosaic, MosaicState,  # noqa: E402
                               ProductRequest, compute_product,
                               incremental_product)
from repro_torch.store import Repository  # noqa: E402

SITES = ["KVNX", "KTLX", "KICT"]
VCP = "VCP-212"
T0 = 1305849600.0
GEOMETRY = dict(n_az=72, n_gates=300, n_sweeps=3)


def _ingest_site(base, site, seed, n_scans, catalog=None):
    raw = RefObjectStore(str(base / f"raw-{site}"))
    generate_raw_archive(raw, site_id=site, n_scans=n_scans, seed=seed,
                         **GEOMETRY)
    path = str(base / f"store-{site}")
    ingest(raw, RefRepository.create(path), batch_size=3, time_chunk=2,
           catalog=catalog, repo_id=site)
    return path


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mosaic")
    ref_cat = RefCatalog.create(str(base / "catalog"))
    for i, site in enumerate(SITES):
        _ingest_site(base, site, 21 + i, 6, catalog=ref_cat)
    return ref_cat, Catalog.open(str(base / "catalog"))


def _both(catalogs, jax_mode="ref", **req):
    ref_cat, cat = catalogs
    want = ref_compute(ref_cat, RefRequest(kind="mosaic", mode=jax_mode,
                                           **req), workers=3)
    got = compute_product(cat, ProductRequest(kind="mosaic", **req),
                          device="cpu", workers=3)
    return got, want


def _assert_bitwise(got, want):
    assert isinstance(got, FederatedMosaic)
    assert got.repo_ids == want.repo_ids
    assert got.composite.dtype == want.composite.dtype
    assert got.composite.tobytes() == want.composite.tobytes()
    for f in ("lat_min", "lat_max", "lon_min", "lon_max", "ny", "nx"):
        assert getattr(got.grid, f) == getattr(want.grid, f)
    for rid in got.repo_ids:
        g, w = got.results[rid], want.results[rid]
        assert g.values.tobytes() == w.values.tobytes()
        np.testing.assert_array_equal(g.times, w.times)
        assert g.product == w.product and g.chunk_fetches == w.chunk_fetches


@pytest.mark.parametrize("jax_mode", ["ref", "kernel"])
@pytest.mark.parametrize("req", [
    dict(product="column_max", ny=48, nx=48),
    dict(product="column_max", ny=32, nx=40, method="idw"),
    dict(product="cappi", altitude_m=2000.0, ny=32, nx=32),
    dict(product="cappi", altitude_m=3500.0, ny=24, nx=24, sweep=1),
])
def test_mosaic_bitwise_equals_the_reference(catalogs, jax_mode, req):
    got, want = _both(catalogs, jax_mode, **req)
    _assert_bitwise(got, want)
    assert got.product == req["product"]
    # the fan-out equals compositing each repository by hand
    seq = np.fmax.reduce(np.stack([got.results[r].composite()
                                   for r in got.repo_ids]), axis=0)
    assert seq.tobytes() == got.composite.tobytes()


def test_mosaic_time_window_fetches_what_the_reference_fetches(catalogs):
    _, cat = catalogs
    t0, t1 = cat.entry("KVNX").time_range()
    window = (t0, t0 + 0.4 * (t1 - t0))
    blind, want_blind = _both(catalogs, ny=32, nx=32)
    pruned, want_pruned = _both(catalogs, ny=32, nx=32, time_between=window)
    _assert_bitwise(blind, want_blind)
    _assert_bitwise(pruned, want_pruned)
    assert 0 < pruned.chunk_fetches < blind.chunk_fetches
    assert pruned.chunk_fetches == want_pruned.chunk_fetches
    assert blind.chunk_fetches == want_blind.chunk_fetches
    for rid in SITES:
        n = pruned.results[rid].values.shape[0]
        assert pruned.results[rid].values.tobytes() == \
            blind.results[rid].values[:n].tobytes()


def test_mosaic_bbox_prunes_repositories(catalogs):
    got, want = _both(catalogs, ny=16, nx=16,
                      within=(38.2, 39.0, -98.5, -97.0))
    assert got.repo_ids == want.repo_ids == ["KICT"]
    _assert_bitwise(got, want)
    with pytest.raises(ValueError, match="matches no repository"):
        compute_product(catalogs[1], ProductRequest(
            kind="mosaic", ny=16, nx=16, within=(10.0, 11.0, 0.0, 1.0)),
            device="cpu")


def test_mosaic_empty_window_is_all_nan(catalogs):
    t0, _ = catalogs[1].entry("KVNX").time_range()
    got, want = _both(catalogs, ny=16, nx=16, time_between=(t0 + 1.0,
                                                            t0 + 2.0))
    assert np.isnan(got.composite).all()
    for r in got.results.values():
        assert r.values.shape[0] == 0
    _assert_bitwise(got, want)


def test_deprecated_alias_and_bad_products(catalogs):
    _, cat = catalogs
    with pytest.warns(DeprecationWarning, match="deprecated"):
        alias = federation.federated_mosaic(cat, ny=16, nx=16,
                                            device="cpu")
    direct = compute_product(cat, ProductRequest(kind="mosaic", ny=16,
                                                 nx=16), device="cpu")
    assert alias.composite.tobytes() == direct.composite.tobytes()
    with pytest.raises(ValueError, match="unknown mosaic product"):
        compute_product(cat, ProductRequest(kind="mosaic", product="vil"),
                        device="cpu")


# ---------------------------------------------------------------------------
# the incremental mosaic, on one copy of the federation per package
# ---------------------------------------------------------------------------

INC_SITES = ("KVNX", "KTLX")
N_BASE, N_APPEND = 4, 2


@pytest.fixture(scope="module")
def inc_base(tmp_path_factory):
    base = tmp_path_factory.mktemp("inc-mosaic")
    return {site: _ingest_site(base, site, 31 + i, N_BASE)
            for i, site in enumerate(INC_SITES)}


def _volumes(site, i):
    """Scan N_BASE + i of ``site`` from each package's simulator (the
    VCP cut to the test geometry)."""
    out = {}
    for who, fm, sim in (("ref", ref_fm301, RefSimulator(seed=7 + i)),
                         ("port", fm301, StormSimulator(seed=7 + i))):
        full = fm.VCPS[VCP]
        vcp = fm.VCPDef(full.vcp_id, full.elevations[:GEOMETRY["n_sweeps"]],
                        GEOMETRY["n_az"], GEOMETRY["n_gates"], full.gate_m,
                        full.interval_s)
        out[who] = sim.volume(fm.SITES[site], vcp,
                              T0 + (N_BASE + i) * vcp.interval_s)
    return out


@pytest.mark.parametrize("product", ["column_max", "cappi"])
def test_incremental_mosaic_bitwise_recomposition(inc_base, tmp_path,
                                                  product):
    ref_cat = RefCatalog.create(str(tmp_path / "ref-cat"))
    cat = Catalog.create(str(tmp_path / "port-cat"))
    for site, path in inc_base.items():
        shutil.copytree(path, tmp_path / f"ref-{site}")
        shutil.copytree(path, tmp_path / f"port-{site}")
        ref_cat.register_repository(
            RefRepository.open(str(tmp_path / f"ref-{site}")), repo_id=site)
        cat.register_repository(
            Repository.open(str(tmp_path / f"port-{site}")), repo_id=site)
    assert cat.store.get("catalog.json") != b""

    req = dict(kind="mosaic", product=product, moment="DBZH", ny=24, nx=24)
    want_inc = ref_incremental(ref_cat, RefRequest(**req))
    inc = incremental_product(cat, ProductRequest(**req), device="cpu")
    assert isinstance(inc, IncrementalMosaic)
    assert inc.device.type == "cpu"
    assert all(m.device.type == "cpu" for m in inc.members.values())

    boot, want_boot = inc.update(), want_inc.update()
    assert boot.n_new_scans == want_boot.n_new_scans == N_BASE * 2
    for i in range(N_APPEND):
        for site in INC_SITES:
            vols = _volumes(site, i)
            sid_ref = RefArchive(ref_cat.open_repository(site)).append_scan(
                vols["ref"])
            sid = RadarArchive(cat.open_repository(site)).append_scan(
                vols["port"])
            assert sid == sid_ref
        rep, want_rep = inc.update(), want_inc.update()
        assert rep.n_new_scans == want_rep.n_new_scans == len(INC_SITES)
        assert 0 < rep.cells_computed < rep.cells_full
        assert (rep.cells_computed, rep.cells_full, rep.chunk_fetches) == \
            (want_rep.cells_computed, want_rep.cells_full,
             want_rep.chunk_fetches)
        assert rep.source_snapshot == want_rep.source_snapshot

        state, want_state = inc.composite(), want_inc.composite()
        assert isinstance(state, MosaicState)
        full = compute_product(cat, ProductRequest(**req).with_options(
            grid=inc.grid), device="cpu")
        assert state.composite.tobytes() == full.composite.tobytes()
        assert state.composite.tobytes() == want_state.composite.tobytes()
        assert state.repo_ids == list(full.repo_ids) == want_state.repo_ids
        for rid in state.repo_ids:
            assert (state.results[rid].values.tobytes()
                    == full.results[rid].values.tobytes()
                    == want_state.results[rid].values.tobytes())
    assert inc.update().noop


def test_incremental_mosaic_validation():
    with pytest.raises(ValueError, match="mosaic"):
        IncrementalMosaic(None, ProductRequest(kind="qvp"), device="cpu")
    with pytest.raises(ValueError, match="unknown mosaic product"):
        IncrementalMosaic(None, ProductRequest(kind="mosaic", product="vil"),
                          device="cpu")
