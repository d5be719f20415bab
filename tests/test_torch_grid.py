"""The port's gridding against the reference package's, on the CPU.

* ``repro_torch.kernels.ref.grid_map`` (the CUDA kernel's plain version)
  against the reference oracle ``repro.kernels.ref.grid_map`` and the
  Pallas kernel in interpret mode, **bitwise**, over the sweeps of
  ``tests/test_kernels.py`` plus the out-of-range index cases.
* The copied geometry and gate maps, bitwise.
* PPI, CAPPI and column-max through both packages' ``compute_product`` on
  one archive (the reference ETL: 6 scans, 72 azimuths, 200 gates, 3
  sweeps), the port on ``device="cpu"``: values bitwise, NaN in the same
  places, equal axes, parameters and chunk fetches.
* Grid-product write-back: round trips, replacement, and each package
  reading the other's products.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.etl import generate_raw_archive, ingest  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.grid_map import grid_map_pallas  # noqa: E402
from repro.radar import geometry as ref_geometry  # noqa: E402
from repro.radar import grid as ref_grid  # noqa: E402
from repro.radar.products import ProductRequest as RefRequest  # noqa: E402
from repro.radar.products import compute_product as ref_compute  # noqa: E402
from repro.store import ObjectStore as RefObjectStore  # noqa: E402
from repro.store import Repository as RefRepository  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.radar import geometry  # noqa: E402
from repro_torch.radar import grid  # noqa: E402
from repro_torch.radar import (CartesianGrid, ProductRequest,  # noqa: E402
                               compute_product, grid_sweep_from_session,
                               read_grid_product, write_grid_product)
from repro_torch.store import Repository  # noqa: E402

VCP = "VCP-212"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _plain_grid_map(field, idx, w):
    return ref.grid_map(_t(field), _t(idx), _t(w)).numpy()


def assert_bitwise(got, want):
    """Equal shapes, NaN in the same places, and every other value equal
    bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    assert got[~nan_g].tobytes() == want[~nan_w].tobytes()


# ---------------------------------------------------------------------------
# grid_map: the plain version against the reference oracle and Pallas
# ---------------------------------------------------------------------------

# (t, g, c, k, seed): the sweep of tests/test_kernels.py:68-75, fixed
GRID_MAP_CASES = [(1, 8, 1, 1, 0), (3, 50, 20, 1, 1), (9, 4000, 3000, 4, 2),
                  (4, 997, 1531, 2, 3), (7, 2048, 777, 8, 4),
                  (2, 1234, 2999, 4, 5), (5, 3001, 64, 8, 6),
                  (8, 640, 1000, 2, 7)]


@pytest.mark.parametrize("t, g, c, k, seed", GRID_MAP_CASES)
@pytest.mark.parametrize("weights", ["uniform", "idw"])
def test_grid_map_plain_matches_oracle_and_pallas_bitwise(t, g, c, k, seed,
                                                          weights):
    rng = np.random.default_rng(seed)
    field = rng.normal(20.0, 12.0, size=(t, g)).astype(np.float32)
    field[rng.random((t, g)) < 0.2] = np.nan
    idx = rng.integers(0, g, size=(c, k)).astype(np.int32)
    if weights == "uniform":
        w = rng.uniform(0.0, 2.0, size=(c, k)).astype(np.float32)
    else:  # inverse squared distances over a 300 km reach, as IDW maps
        d = rng.uniform(1.0, 3e5, size=(c, k))
        w = (1.0 / np.maximum(d, 1.0) ** 2).astype(np.float32)
    w[rng.random((c, k)) < 0.3] = 0.0     # dropped neighbours
    got = _plain_grid_map(field, idx, w)
    assert got.tobytes() == np.asarray(jref.grid_map(field, idx, w)).tobytes()
    pallas = grid_map_pallas(field, idx, w, bt=4, bc=256, interpret=True)
    assert got.tobytes() == np.asarray(pallas).tobytes()


def test_grid_map_nearest_is_plain_gather():
    rng = np.random.default_rng(1)
    field = rng.normal(size=(3, 50)).astype(np.float32)
    idx = rng.integers(0, 50, size=(20, 1)).astype(np.int32)
    w = np.ones((20, 1), np.float32)
    np.testing.assert_array_equal(_plain_grid_map(field, idx, w),
                                  field[:, idx[:, 0]])


def test_grid_map_zero_weight_cell_is_nan():
    field = np.ones((2, 16), np.float32)
    idx = np.zeros((5, 4), np.int32)
    w = np.zeros((5, 4), np.float32)
    w[2] = 1.0
    out = _plain_grid_map(field, idx, w)
    assert np.isnan(out[:, [0, 1, 3, 4]]).all()
    np.testing.assert_array_equal(out[:, 2], 1.0)


def test_grid_map_empty_axes_match_oracle():
    idx = np.zeros((5, 2), np.int32)
    w = np.ones((5, 2), np.float32)
    empty_t = np.empty((0, 16), np.float32)
    out = _plain_grid_map(empty_t, idx, w)
    assert out.shape == np.asarray(jref.grid_map(empty_t, idx, w)).shape
    assert out.shape == (0, 5)
    out = _plain_grid_map(np.ones((3, 16), np.float32),
                          np.zeros((0, 2), np.int32),
                          np.zeros((0, 2), np.float32))
    assert out.shape == (3, 0)
    # k = 0: no gate contributes anywhere
    out = _plain_grid_map(np.ones((3, 16), np.float32),
                          np.zeros((4, 0), np.int32),
                          np.zeros((4, 0), np.float32))
    assert out.shape == (3, 4) and np.isnan(out).all()


def test_grid_map_skips_nan_gates():
    field = np.array([[1.0, np.nan, 3.0]], np.float32)
    idx = np.array([[0, 1], [1, 2]], np.int32)
    w = np.ones((2, 2), np.float32)
    np.testing.assert_allclose(_plain_grid_map(field, idx, w), [[1.0, 3.0]])


@pytest.mark.parametrize("index", [8, 9, 1000, -1, -5, -8, -9, -1000])
def test_grid_map_out_of_range_indices_follow_the_oracle(index):
    """jnp.take's fill rule: an index >= G reads NaN (the gate is skipped),
    a negative index wraps by G once, and one still negative reads NaN."""
    rng = np.random.default_rng(index % 97)
    field = rng.normal(20.0, 12.0, size=(3, 8)).astype(np.float32)
    idx = np.array([[index, 2], [index, index], [3, index]], np.int32)
    w = np.array([[1.0, 0.5], [2.0, 1.0], [0.25, 4.0]], np.float32)
    got = _plain_grid_map(field, idx, w)
    assert got.tobytes() == np.asarray(jref.grid_map(field, idx, w)).tobytes()


def test_grid_map_kernel_mode_needs_a_cuda_tensor():
    field = torch.ones(2, 8)
    idx = torch.zeros(3, 1, dtype=torch.int32)
    w = torch.ones(3, 1)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.grid_map(field, idx, w, mode="kernel")
    # auto on a CPU tensor is the plain version, ref is too
    auto = ops.grid_map(field, idx, w)
    assert torch.equal(auto, ops.grid_map(field, idx, w, mode="ref"))


# ---------------------------------------------------------------------------
# Geometry and gate maps: numpy copies, bitwise
# ---------------------------------------------------------------------------

SITES = [(36.74, -98.13), (78.2, 15.6), (-77.8, 166.7), (64.5, 179.9),
         (-20.0, -179.95), (0.0, 0.0)]


@pytest.mark.parametrize("site_lat, site_lon", SITES)
def test_geometry_bitwise_equal_to_reference(site_lat, site_lon):
    rng = np.random.default_rng(int(abs(site_lat * 10)))
    r = np.linspace(125.0, 298e3, 97)
    az = rng.uniform(0.0, 360.0, size=(97,))
    for elev in (0.5, 1.3, 19.5):
        for a, b in ((geometry.beam_height_m(r, elev, 350.0),
                      ref_geometry.beam_height_m(r, elev, 350.0)),
                     (geometry.ground_range_m(r, elev),
                      ref_geometry.ground_range_m(r, elev))):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        for method in ("spherical", "equirect"):
            got = geometry.gate_latlon(site_lat, site_lon, az, r, elev,
                                       method=method)
            want = ref_geometry.gate_latlon(site_lat, site_lon, az, r, elev,
                                            method=method)
            for a, b in zip(got, want):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    lon = rng.uniform(-540.0, 540.0, size=(50,))
    assert geometry.wrap_lon(lon).tobytes() == \
        ref_geometry.wrap_lon(lon).tobytes()
    lat = rng.uniform(-90.0, 90.0, size=(50,))
    for a, b in zip(geometry.latlon_to_polar(site_lat, site_lon, lat, lon),
                    ref_geometry.latlon_to_polar(site_lat, site_lon, lat,
                                                 lon)):
        assert a.tobytes() == b.tobytes()
    assert geometry.reach_box_deg(site_lat, 298e3) == \
        ref_geometry.reach_box_deg(site_lat, 298e3)
    with pytest.raises(ValueError, match="unknown method"):
        geometry.gate_latlon(site_lat, site_lon, az, r, 0.5, method="flat")


GRID_GEOMETRY = dict(azimuth=(np.arange(72) + 0.5) * 5.0,
                     range_m=(np.arange(200) + 0.5) * 250.0)


@pytest.mark.parametrize("method", ["nearest", "idw"])
@pytest.mark.parametrize("site_lat, site_lon", SITES[:4])
def test_build_mapping_bitwise_equal_to_reference(site_lat, site_lon,
                                                  method):
    az, rng_m = GRID_GEOMETRY["azimuth"], GRID_GEOMETRY["range_m"]
    kw = dict(ny=24, nx=30)
    want_grid = ref_grid.CartesianGrid.around(site_lat, site_lon, 50e3, **kw)
    got_grid = CartesianGrid.around(site_lat, site_lon, 50e3, **kw)
    assert got_grid.__dict__ == want_grid.__dict__
    got = grid.build_mapping(site_lat, site_lon, az, rng_m, 0.5, got_grid,
                             method=method)
    want = ref_grid.build_mapping(site_lat, site_lon, az, rng_m, 0.5,
                                  want_grid, method=method)
    assert got.gate_idx.tobytes() == want.gate_idx.tobytes()
    assert got.weights.tobytes() == want.weights.tobytes()
    assert (got.n_az, got.n_gates, got.method, got.elev_deg) == \
        (want.n_az, want.n_gates, want.method, want.elev_deg)
    np.testing.assert_array_equal(got.in_reach(), want.in_reach())
    assert got.in_reach().any() and not got.in_reach().all()

    elevs = [0.5, 0.9, 1.3]
    got_c = grid._cappi_mapping(site_lat, site_lon, 350.0, az, rng_m, elevs,
                                got_grid, method, 2000.0)
    want_c = ref_grid._cappi_mapping(site_lat, site_lon, 350.0, az, rng_m,
                                     elevs, want_grid, method, 2000.0)
    assert got_c.gate_idx.tobytes() == want_c.gate_idx.tobytes()
    assert got_c.weights.tobytes() == want_c.weights.tobytes()
    assert got_c.method == want_c.method == f"cappi-{method}"


def test_mapping_cache_hits_and_freezes():
    grid.clear_mapping_cache()
    az, rng_m = GRID_GEOMETRY["azimuth"], GRID_GEOMETRY["range_m"]
    g = CartesianGrid.around(36.74, -98.13, 50e3, 12, 12)
    first = grid.build_mapping(36.74, -98.13, az, rng_m, 0.5, g)
    again = grid.build_mapping(36.74, -98.13, az, rng_m, 0.5, g)
    assert first is again
    assert grid.mapping_cache_stats() == {"hits": 1, "misses": 1,
                                          "entries": 1}
    with pytest.raises(ValueError):
        first.gate_idx[0, 0] = 1
    grid.clear_mapping_cache()
    assert grid.mapping_cache_stats()["entries"] == 0
    with pytest.raises(ValueError, match="unknown method"):
        grid.build_mapping(36.74, -98.13, az, rng_m, 0.5, g, method="cubic")


@pytest.mark.parametrize("bad", [
    (40.0, 39.0, 0.0, 1.0, 4, 4), (-91.0, 0.0, 0.0, 1.0, 4, 4),
    (0.0, 1.0, 5.0, 4.0, 4, 4), (0.0, 1.0, 179.0, 181.0, 4, 4),
    (0.0, 1.0, 0.0, 1.0, 0, 4)])
def test_cartesian_grid_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        ref_grid.CartesianGrid(*bad)
    with pytest.raises(ValueError):
        CartesianGrid(*bad)


def test_cartesian_grid_covering_matches_reference():
    boxes = [{"lat_min": 35.0, "lat_max": 38.0, "lon_min": -99.0,
              "lon_max": -96.0}, {}, {"lat_min": 88.0, "lat_max": 91.0,
                                     "lon_min": -100.0, "lon_max": -97.5}]
    got = CartesianGrid.covering(boxes, 10, 12)
    want = ref_grid.CartesianGrid.covering(boxes, 10, 12)
    assert got.__dict__ == want.__dict__
    assert got.lats().tobytes() == want.lats().tobytes()
    assert got.lons().tobytes() == want.lons().tobytes()
    with pytest.raises(ValueError, match="no bounding boxes"):
        CartesianGrid.covering([{}])


# ---------------------------------------------------------------------------
# Products through both packages' compute_product
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    raw = RefObjectStore(str(tmp_path_factory.mktemp("raw")))
    generate_raw_archive(raw, n_scans=6, n_az=72, n_gates=200, n_sweeps=3,
                         seed=3)
    path = str(tmp_path_factory.mktemp("repo"))
    ingest(raw, RefRepository.create(path), batch_size=3)
    return path


def _explicit_grid(path, package):
    root = RefRepository.open(path).readonly_session().group_attrs("")
    lat, lon = root["latitude"], root["longitude"]
    # wider than the 50 km reach, off-centre, and not square
    return package.CartesianGrid(lat - 0.6, lat + 0.55, lon - 0.8,
                                 lon + 0.7, 31, 37)


def _both(path, kind, **req):
    explicit = req.pop("explicit_grid", False)
    ref_req = dict(req)
    if explicit:
        ref_req["grid"] = _explicit_grid(path, ref_grid)
        req["grid"] = _explicit_grid(path, grid)
    session = RefRepository.open(path).readonly_session()
    try:
        if kind == "ppi":
            want = ref_grid.grid_sweep_from_session(session, **ref_req)
        else:
            want = ref_compute(session, RefRequest(kind=kind, **ref_req))
    finally:
        session.close()
    with Repository.open(path).readonly_session() as session:
        if kind == "ppi":
            got = grid_sweep_from_session(session, device="cpu", **req)
        else:
            got = compute_product(session, ProductRequest(kind=kind, **req),
                                  device="cpu")
    return got, want


def assert_same_product(got, want):
    assert isinstance(got, grid.GridProduct)
    assert got.values.dtype == np.float32
    assert_bitwise(got.values, want.values)
    assert got.times.tobytes() == want.times.tobytes()
    assert got.grid.__dict__ == want.grid.__dict__
    assert (got.moment, got.product, got.params) == \
        (want.moment, want.product, want.params)
    assert got.chunk_fetches == want.chunk_fetches > 0


@pytest.mark.parametrize("explicit_grid", [False, True])
@pytest.mark.parametrize("time_slice", [None, (1, 5)])
@pytest.mark.parametrize("method", ["nearest", "idw"])
@pytest.mark.parametrize("kind", ["ppi", "cappi", "column_max"])
def test_grid_products_match_reference_bitwise(archive, kind, method,
                                               time_slice, explicit_grid):
    req = dict(vcp=VCP, method=method, time_slice=time_slice, ny=40, nx=44,
               explicit_grid=explicit_grid)
    if kind == "ppi":
        req["sweep"] = 1
    got, want = _both(archive, kind, **req)
    assert_same_product(got, want)
    n_t = 6 if time_slice is None else 4
    assert got.values.shape[0] == n_t
    finite = np.isfinite(got.values)
    assert finite.any() and not finite.all()


def test_cappi_sweep_subset_and_altitude_match_reference(archive):
    got, want = _both(archive, "cappi", vcp=VCP, sweeps=(0, 2),
                      altitude_m=3500.0, ny=24, nx=24)
    assert_same_product(got, want)
    assert got.params["sweeps"] == [0, 2]


def test_empty_time_window_grids_to_nothing(archive):
    got, want = _both(archive, "column_max", vcp=VCP, time_slice=(3, 3),
                      ny=24, nx=24)
    assert got.values.shape == want.values.shape == (0, 24, 24)
    assert np.isnan(got.composite()).all()


def test_grid_products_need_the_gpu_unless_cpu_is_asked(archive,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with Repository.open(archive).readonly_session() as session:
        for kind in ("cappi", "column_max"):
            req = ProductRequest(kind=kind, vcp=VCP, ny=24, nx=24)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                compute_product(session, req)
            with pytest.raises(RuntimeError, match="CUDA tensor"):
                compute_product(session, req.with_options(mode="kernel"),
                                device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            grid_sweep_from_session(session, vcp=VCP, sweep=0)


# ---------------------------------------------------------------------------
# Write-back
# ---------------------------------------------------------------------------


def test_write_read_round_trip_and_replace(archive, tmp_path):
    import shutil

    path = str(tmp_path / "repo")
    shutil.copytree(archive, path)
    repo = Repository.open(path)
    with repo.readonly_session() as session:
        prod = compute_product(session, ProductRequest(
            kind="cappi", vcp=VCP, ny=24, nx=28), device="cpu")
        prod2 = compute_product(session, ProductRequest(
            kind="cappi", vcp=VCP, ny=24, nx=28, time_slice=(0, 2)),
            device="cpu")
    sid = write_grid_product(repo, prod, name="cappi_test", time_chunk=4)
    assert repo.branch_head() == sid
    with repo.readonly_session() as session:
        back = read_grid_product(session, "cappi_test")
        n_arrays = len(session.list_arrays("products/cappi_test/"))
    assert back.values.tobytes() == prod.values.tobytes()
    assert back.times.tobytes() == prod.times.tobytes()
    assert back.grid == prod.grid and back.params == prod.params
    assert back.product == "cappi" and back.moment == "DBZH"
    assert grid.product_path(prod, "cappi_test") == "products/cappi_test"
    assert grid.product_path(prod) == "products/cappi_DBZH"
    # re-writing the name replaces the product (delete_array), and the
    # old version stays readable at the old snapshot
    write_grid_product(repo, prod2, name="cappi_test")
    with repo.readonly_session() as session:
        back2 = read_grid_product(session, "cappi_test")
        assert len(session.list_arrays("products/cappi_test/")) == n_arrays
    assert back2.values.tobytes() == prod2.values.tobytes()
    assert back2.values.shape[0] == 2
    with repo.readonly_session(snapshot_id=sid) as session:
        old = read_grid_product(session, "cappi_test")
    assert old.values.tobytes() == prod.values.tobytes()


def test_write_back_commits_the_reference_snapshot_and_reads_across(
        archive, tmp_path):
    """The same product written by either package gives the same snapshot
    id (delete_array included), and each package reads the other's."""
    import shutil

    paths = {}
    for who in ("ref", "port"):
        paths[who] = str(tmp_path / who)
        shutil.copytree(archive, paths[who])
    with Repository.open(paths["port"]).readonly_session() as session:
        prod = compute_product(session, ProductRequest(
            kind="column_max", vcp=VCP, ny=20, nx=22), device="cpu")
    ref_prod = ref_grid.GridProduct(
        prod.values, prod.times,
        ref_grid.CartesianGrid(*prod.grid.__dict__.values()), prod.moment,
        prod.product, prod.params)
    for _ in range(2):   # the second write replaces the first
        sid_ref = ref_grid.write_grid_product(RefRepository.open(
            paths["ref"]), ref_prod, name="cm")
        sid_port = write_grid_product(Repository.open(paths["port"]), prod,
                                      name="cm")
        assert sid_port == sid_ref
    port_read = read_grid_product(
        Repository.open(paths["ref"]).readonly_session(), "cm")
    ref_read = ref_grid.read_grid_product(
        RefRepository.open(paths["port"]).readonly_session(), "cm")
    for back in (port_read, ref_read):
        assert back.values.tobytes() == prod.values.tobytes()
        assert back.times.tobytes() == prod.times.tobytes()
        assert back.params == prod.params
        assert back.grid.__dict__ == prod.grid.__dict__
