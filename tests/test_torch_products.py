"""The port's QVP and QPE against the reference package's, on one archive.

The archive is built as ``tests/test_radar_workflows.py`` builds it (the
reference ETL: 6 scans, 72 azimuths, 200 gates, 4 sweeps); the port opens
the same directory with its own store.  Each product goes through
``repro.radar.products.compute_product`` (plain reference, and the Pallas
kernel in interpret mode) and through
``repro_torch.radar.products.compute_product(..., device="cpu")``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.etl import generate_raw_archive, ingest, level2  # noqa: E402
from repro.radar import qpe_from_volumes as ref_qpe_from_volumes  # noqa: E402
from repro.radar import qvp_from_volumes as ref_qvp_from_volumes  # noqa: E402
from repro.radar.products import ProductRequest as RefRequest  # noqa: E402
from repro.radar.products import compute_product as ref_compute  # noqa: E402
from repro.store import ObjectStore as RefObjectStore  # noqa: E402
from repro.store import Repository as RefRepository  # noqa: E402
from repro_torch.core import RadarArchive  # noqa: E402
from repro_torch.radar import (ProductRequest, compute_product,  # noqa: E402
                               qpe_from_volumes, qvp_from_volumes)
from repro_torch.store import Repository  # noqa: E402

QVP_TOL = dict(rtol=1e-5, atol=1e-5)
QPE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    raw = RefObjectStore(str(tmp_path_factory.mktemp("raw")))
    keys = generate_raw_archive(
        raw, n_scans=6, n_az=72, n_gates=200, n_sweeps=4, seed=3
    )
    path = str(tmp_path_factory.mktemp("repo"))
    ingest(raw, RefRepository.create(path), batch_size=3)
    volumes = [level2.decode_volume(raw.get(k)) for k in keys]
    return path, volumes


def _both(archive, jax_mode, **req):
    path, _ = archive
    want = ref_compute(RefRepository.open(path).readonly_session(),
                       RefRequest(mode=jax_mode, **req))
    with RadarArchive(Repository.open(path)).session() as session:
        got = compute_product(session, ProductRequest(**req), device="cpu")
    return got, want


@pytest.mark.parametrize("jax_mode", ["ref", "kernel"])
@pytest.mark.parametrize("time_slice", [None, (1, 5)])
@pytest.mark.parametrize("quality_moment", ["RHOHV", None])
@pytest.mark.parametrize("sweep", [2, 3])
def test_qvp_matches_reference(archive, sweep, quality_moment, time_slice,
                               jax_mode):
    got, want = _both(archive, jax_mode, kind="qvp", vcp="VCP-212",
                      sweep=sweep, quality_moment=quality_moment,
                      time_slice=time_slice)
    assert got.profile.dtype == np.float32
    assert got.profile.shape == want.profile.shape
    np.testing.assert_allclose(got.profile, want.profile, **QVP_TOL)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.height_m, want.height_m)
    assert got.moment == want.moment
    assert got.elevation_deg == want.elevation_deg


@pytest.mark.parametrize("jax_mode", ["ref", "kernel"])
@pytest.mark.parametrize("time_slice", [None, (2, 6)])
def test_qpe_matches_reference(archive, time_slice, jax_mode):
    got, want = _both(archive, jax_mode, kind="qpe", vcp="VCP-212", sweep=0,
                      time_slice=time_slice)
    assert got.accum_mm.dtype == np.float32
    assert got.accum_mm.shape == want.accum_mm.shape == (72, 200)
    np.testing.assert_allclose(got.accum_mm, want.accum_mm, **QPE_TOL)
    np.testing.assert_array_equal(got.azimuth, want.azimuth)
    np.testing.assert_array_equal(got.range_m, want.range_m)
    assert got.total_hours == want.total_hours
    assert got.n_scans == want.n_scans


def test_products_match_the_file_based_baselines(archive):
    """The port's archive path against its own copies of the file-based
    baselines (tolerances of tests/test_radar_workflows.py), which in turn
    equal the reference's baselines exactly."""
    path, volumes = archive
    with RadarArchive(Repository.open(path)).session() as session:
        qvp = compute_product(session, ProductRequest(
            kind="qvp", vcp="VCP-212", sweep=3), device="cpu")
        qpe = compute_product(session, ProductRequest(
            kind="qpe", vcp="VCP-212", sweep=0), device="cpu")
    base_qvp = qvp_from_volumes(volumes, sweep=3)
    np.testing.assert_allclose(qvp.profile, base_qvp.profile, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(qvp.height_m, base_qvp.height_m, rtol=1e-6)
    base_qpe = qpe_from_volumes(volumes, sweep=0)
    np.testing.assert_allclose(qpe.accum_mm, base_qpe.accum_mm, rtol=1e-3,
                               atol=1e-4)
    assert qpe.n_scans == base_qpe.n_scans == 6
    ref_qvp = ref_qvp_from_volumes(volumes, sweep=3)
    ref_qpe = ref_qpe_from_volumes(volumes, sweep=0)
    assert base_qvp.profile.tobytes() == ref_qvp.profile.tobytes()
    assert base_qpe.accum_mm.tobytes() == ref_qpe.accum_mm.tobytes()
    assert base_qpe.total_hours == ref_qpe.total_hours


def test_compute_product_needs_the_gpu_unless_cpu_is_asked(archive,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, _ = archive
    req = ProductRequest(kind="qvp", vcp="VCP-212", sweep=3)
    with RadarArchive(Repository.open(path)).session() as session:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compute_product(session, req)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compute_product(session, req, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA tensor"):
            compute_product(session, req.with_options(mode="kernel"),
                            device="cpu")


@pytest.mark.parametrize("kind, error", [
    ("mosaic", ValueError),      # a session target cannot mosaic
])
def test_unported_kinds_raise(archive, kind, error):
    """Every session kind is ported (cappi and column_max in
    tests/test_torch_grid.py); the mosaic needs a Catalog target."""
    path, _ = archive
    with RadarArchive(Repository.open(path)).session() as session:
        with pytest.raises(error, match="needs a Catalog target"):
            compute_product(session, ProductRequest(kind=kind, vcp="VCP-212"),
                            device="cpu")


def test_request_validation_and_catalog_targets():
    class CatalogLike:
        def open_session(self):
            raise AssertionError("not reached")

        def entries(self):
            return {}

    with pytest.raises(ValueError, match="unknown product kind"):
        ProductRequest(kind="vil")
    with pytest.raises(TypeError):
        compute_product(object(), {"kind": "qvp"}, device="cpu")
    # a catalog target goes to the federation (tests/test_torch_catalog.py
    # and tests/test_torch_mosaic.py hold its products against the
    # reference's): an empty catalog matches no repository, and a kind
    # with no federated form says so
    for kind in ("qpe", "qvp", "mosaic"):
        with pytest.raises(ValueError, match="matches no repository"):
            compute_product(CatalogLike(), ProductRequest(kind=kind,
                                                          sweep=0),
                            device="cpu")
    with pytest.raises(ValueError, match="no federated form"):
        compute_product(CatalogLike(), ProductRequest(kind="cappi"),
                        device="cpu")
    with pytest.raises(ValueError, match="requires"):
        compute_product(object(), ProductRequest(kind="qvp", vcp="VCP-212"),
                        device="cpu")
