"""The port's incremental products against the reference package's, on the CPU.

* ``repro_torch.kernels.ref.grid_update`` (the CUDA kernel's plain
  version) against the reference oracle and the Pallas kernel in
  interpret mode, **bitwise**, over the sweeps of ``tests/test_kernels.py``.
* Two copies of one archive (the reference ETL: 6 scans, 72 azimuths,
  200 gates, 3 sweeps, two scans per time chunk).  The same 3 simulator
  volumes are appended to each, one commit per scan: the port's copy
  through ``repro_torch.core.RadarArchive``, the reference's through
  ``repro.core.RadarArchive``.  After each append both packages'
  incremental CAPPI, column-max and QPE catch up; the port's state must
  equal its own from-scratch product and the reference's state bit for
  bit, with the same cells computed and chunks fetched, and the two
  archives must keep equal snapshot ids throughout.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import RadarArchive as RefArchive  # noqa: E402
from repro.core import fm301 as ref_fm301  # noqa: E402
from repro.etl import StormSimulator as RefSimulator  # noqa: E402
from repro.etl import generate_raw_archive, ingest  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.grid_update import grid_update_pallas  # noqa: E402
from repro.radar import incremental_product as ref_incremental  # noqa: E402
from repro.radar.products import ProductRequest as RefRequest  # noqa: E402
from repro.store import ObjectStore as RefObjectStore  # noqa: E402
from repro.store import Repository as RefRepository  # noqa: E402
from repro_torch.core import RadarArchive, fm301  # noqa: E402
from repro_torch.etl import StormSimulator  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.radar import (IncrementalGridProduct,  # noqa: E402
                               IncrementalQPE, ProductRequest,
                               compute_product, incremental_product,
                               streaming_qpe)
from repro_torch.radar import incremental  # noqa: E402
from repro_torch.store import Repository  # noqa: E402

VCP = "VCP-212"
T0 = 1305849600.0
N_BASE, N_APPEND, SEED = 6, 3, 3
GEOMETRY = dict(n_az=72, n_gates=200, n_sweeps=3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# grid_update: the plain version against the reference oracle and Pallas
# ---------------------------------------------------------------------------


def _update_case(t, c, seed, touched_frac, beyond=False):
    rng = np.random.default_rng(seed)
    state = rng.normal(20.0, 12.0, size=(t, c)).astype(np.float32)
    state[rng.random((t, c)) < 0.2] = np.nan
    touched = rng.random(c) < touched_frac
    m = int(touched.sum())
    pos = np.full(c, -1, np.int32)
    pos[touched] = rng.permutation(m).astype(np.int32)
    if beyond and m:
        # columns past the update block read NaN (jnp.take's fill)
        pos[np.flatnonzero(touched)[: max(1, m // 10)]] = m + 3
    pos[rng.random(c) < 0.05] = -7     # any negative keeps the state
    upd = rng.normal(20.0, 12.0, size=(t, m)).astype(np.float32)
    upd[rng.random((t, m)) < 0.2] = np.nan
    return state, upd, pos


@pytest.mark.parametrize("op", ["set", "add", "max"])
@pytest.mark.parametrize("t, c, seed, touched_frac, beyond", [
    (1, 1, 0, 1.0, False), (4, 3000, 1, 0.1, False),
    (9, 1777, 2, 0.5, True), (2, 2999, 3, 1.0, True),
    (7, 256, 4, 0.0, False)])
def test_grid_update_plain_matches_oracle_and_pallas_bitwise(
        t, c, seed, touched_frac, beyond, op):
    state, upd, pos = _update_case(t, c, seed, touched_frac, beyond)
    got = ref.grid_update(_t(state), _t(upd), _t(pos), op=op).numpy()
    want = np.asarray(jref.grid_update(state, upd, pos, op=op))
    assert got.tobytes() == want.tobytes()
    if pos.max() < upd.shape[1]:   # the Pallas kernel reads in range only
        pallas = grid_update_pallas(state, upd, pos, op=op, bt=4, bc=256,
                                    interpret=True)
        assert got.tobytes() == np.asarray(pallas).tobytes()


def test_grid_update_untouched_cells_pass_through_bitwise():
    state = np.array([[1.0, np.nan, 3.0, 4.0]], np.float32)
    upd = np.array([[99.0]], np.float32)
    pos = np.array([-1, -1, 0, -1], np.int32)
    out = ref.grid_update(_t(state), _t(upd), _t(pos)).numpy()
    np.testing.assert_array_equal(out, [[1.0, np.nan, 99.0, 4.0]])
    assert out[:, 1].tobytes() == state[:, 1].tobytes()


def test_grid_update_ops_semantics():
    state = _t(np.array([[2.0, np.nan, 5.0]], np.float32))
    upd = _t(np.array([[3.0, 1.0, np.nan]], np.float32))
    pos = _t(np.array([0, 1, 2], np.int32))
    np.testing.assert_array_equal(ref.grid_update(state, upd, pos, op="set"),
                                  upd)
    np.testing.assert_array_equal(ref.grid_update(state, upd, pos, op="add"),
                                  [[5.0, np.nan, np.nan]])
    # fmax: NaN only where *both* sides are NaN
    np.testing.assert_array_equal(ref.grid_update(state, upd, pos, op="max"),
                                  [[3.0, 1.0, 5.0]])


def test_grid_update_empty_axes_return_the_state():
    state = np.ones((2, 4), np.float32)
    out = ref.grid_update(_t(state), _t(np.empty((2, 0), np.float32)),
                          _t(np.full(4, -1, np.int32)))
    np.testing.assert_array_equal(out, state)
    out = ref.grid_update(_t(np.empty((0, 4), np.float32)),
                          _t(np.empty((0, 2), np.float32)),
                          _t(np.array([0, -1, 1, -1], np.int32)))
    assert tuple(out.shape) == (0, 4)
    out = ref.grid_update(_t(np.empty((2, 0), np.float32)),
                          _t(np.empty((2, 3), np.float32)),
                          _t(np.empty((0,), np.int32)))
    assert tuple(out.shape) == (2, 0)


def test_grid_update_rejects_unknown_op_and_cpu_kernel_mode():
    state = torch.ones(1, 2)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown grid_update op"):
        ref.grid_update(state, state, pos, op="mul")
    cells = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown grid_update op"):
        ops.grid_scatter_(state, state[:, :1], cells, op="mul")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.grid_scatter_(state, state[:, :1], cells, mode="kernel")


# ---------------------------------------------------------------------------
# Incremental products on two copies of one archive
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base_archive(tmp_path_factory):
    raw = RefObjectStore(str(tmp_path_factory.mktemp("raw")))
    generate_raw_archive(raw, n_scans=N_BASE, seed=SEED, **GEOMETRY)
    path = str(tmp_path_factory.mktemp("repo"))
    # two scans per time chunk, so an update that reads only the new
    # scans fetches strictly fewer chunks than a rebuild
    ingest(raw, RefRepository.create(path), batch_size=3, time_chunk=2)
    return path


def _appended_volumes():
    """The 3 scans after the base archive, from each package's simulator
    (the archive's own VCP cut to the test geometry)."""
    out = {}
    for who, fm, sim in (("ref", ref_fm301, RefSimulator(seed=SEED)),
                         ("port", fm301, StormSimulator(seed=SEED))):
        full = fm.VCPS[VCP]
        vcp = fm.VCPDef(full.vcp_id, full.elevations[:GEOMETRY["n_sweeps"]],
                        GEOMETRY["n_az"], GEOMETRY["n_gates"], full.gate_m,
                        full.interval_s)
        out[who] = [sim.volume(fm.SITES["KVNX"], vcp,
                               T0 + (N_BASE + i) * vcp.interval_s)
                    for i in range(N_APPEND)]
    return out


@pytest.fixture
def two_copies(base_archive, tmp_path):
    paths = {}
    for who in ("ref", "port"):
        paths[who] = str(tmp_path / who)
        shutil.copytree(base_archive, paths[who])
    return paths


def _fresh(repo, fn):
    """``fn(session)`` on a cold session -> (result, chunks fetched)."""
    with repo.readonly_session() as session:
        before = session.cache_stats()["chunk_fetches"]
        out = fn(session)
        return out, session.cache_stats()["chunk_fetches"] - before


def _same_report(got, want):
    assert got.name == want.name and got.kind == want.kind
    assert (got.n_new_scans, got.cells_computed, got.cells_full,
            got.chunk_fetches) == (want.n_new_scans, want.cells_computed,
                                   want.cells_full, want.chunk_fetches)
    assert got.source_snapshot == want.source_snapshot
    assert (got.snapshot_id is None) == (want.snapshot_id is None)
    if got.snapshot_id is not None:
        assert got.snapshot_id == want.snapshot_id


REQUESTS = {
    "cappi": dict(kind="cappi", ny=36, nx=40),
    "column_max": dict(kind="column_max", ny=24, nx=24, method="idw"),
    "qpe": dict(kind="qpe", sweep=0),
}


@pytest.mark.parametrize("kind", sorted(REQUESTS))
def test_incremental_state_matches_scratch_and_reference_bitwise(two_copies,
                                                                 kind):
    ref_repo = RefRepository.open(two_copies["ref"])
    repo = Repository.open(two_copies["port"])
    req = REQUESTS[kind]
    want_inc = ref_incremental(ref_repo, RefRequest(**req))
    inc = incremental_product(repo, ProductRequest(**req), device="cpu")
    assert isinstance(inc, IncrementalQPE if kind == "qpe"
                      else IncrementalGridProduct)
    ref_archive = RefArchive(ref_repo)
    archive = RadarArchive(repo)
    volumes = _appended_volumes()

    boot = inc.update()
    _same_report(boot, want_inc.update())
    assert boot.n_new_scans == N_BASE
    for i in range(N_APPEND):
        sid_ref = ref_archive.append_scan(volumes["ref"][i])
        sid = archive.append_scan(volumes["port"][i])
        assert sid == sid_ref == repo.branch_head() == ref_repo.branch_head()

        rep = inc.update()
        _same_report(rep, want_inc.update())
        assert rep.n_new_scans == 1
        assert 0 < rep.cells_computed < rep.cells_full
        assert repo.branch_head() == ref_repo.branch_head() == rep.snapshot_id

        state, want = inc.read(), want_inc.read()
        if kind == "qpe":
            full, full_fetches = _fresh(repo, lambda s: streaming_qpe(
                s, vcp=VCP, sweep=0))
            assert state.accum_mm.dtype == np.float32
            assert state.accum_mm.tobytes() == full.accum_mm.tobytes()
            assert state.accum_mm.tobytes() == want.accum_mm.tobytes()
            assert state.n_scans == full.n_scans == want.n_scans \
                == N_BASE + i + 1
            assert state.seconds == full.seconds == want.seconds
            assert state.t_last == full.t_last == want.t_last
        else:
            full_req = ProductRequest(vcp=VCP, grid=state.grid, **req)
            full, full_fetches = _fresh(repo, lambda s: compute_product(
                s, full_req, device="cpu"))
            assert state.values.dtype == np.float32
            assert state.values.tobytes() == full.values.tobytes()
            assert state.values.tobytes() == want.values.tobytes()
            assert state.times.tobytes() == full.times.tobytes() \
                == want.times.tobytes()
            assert state.values.shape[0] == N_BASE + i + 1
            assert np.isfinite(state.values).any()
        assert rep.chunk_fetches < full_fetches

        head = repo.branch_head()
        noop = inc.update()
        assert noop.noop and noop.cells_computed == 0
        _same_report(noop, want_inc.update())
        assert repo.branch_head() == head == ref_repo.branch_head()


def test_streaming_qpe_matches_reference(base_archive):
    from repro.radar import streaming_qpe as ref_streaming_qpe

    with Repository.open(base_archive).readonly_session() as session:
        got = streaming_qpe(session, vcp=VCP, sweep=1, a=300.0, b=1.4)
    want = ref_streaming_qpe(RefRepository.open(base_archive)
                             .readonly_session(), vcp=VCP, sweep=1,
                             a=300.0, b=1.4)
    assert got.accum_mm.tobytes() == want.accum_mm.tobytes()
    assert (got.seconds, got.n_scans, got.t_last, got.total_hours) == \
        (want.seconds, want.n_scans, want.t_last, want.total_hours)


def test_sparse_fold_equals_dense_fold():
    """The device fold through grid_update equals the host's dense fold
    bitwise, including scans where it rained nowhere."""
    rng = np.random.default_rng(11)
    dbz = rng.normal(10.0, 15.0, size=(5, 12, 30)).astype(np.float32)
    dbz[2] = -10.0                     # a dry scan
    dbz[rng.random(dbz.shape) < 0.1] = np.nan
    rates = incremental._zr_rate_rows(dbz, a=200.0, b=1.6)
    dt = incremental._rect_dt(T0 + 270.0 * np.arange(5), None)
    start = np.abs(rng.normal(size=12 * 30)).astype(np.float32)
    dense, n_dense = incremental._fold_terms(start, rates, dt)
    sparse, n_sparse = incremental._fold_terms(start, rates, dt, sparse=True,
                                               device="cpu")
    assert dense.tobytes() == sparse.tobytes()
    assert n_sparse == int((rates > 0).sum()) < n_dense == rates.size


def test_incremental_factory_validation_and_device(base_archive,
                                                   monkeypatch):
    repo = Repository.open(base_archive)
    with pytest.raises(ValueError, match="cappi|column_max"):
        IncrementalGridProduct(repo, ProductRequest(kind="qpe"),
                               device="cpu")
    with pytest.raises(ValueError, match="qpe"):
        IncrementalQPE(repo, ProductRequest(kind="cappi"), device="cpu")
    with pytest.raises(ValueError, match="no incremental maintainer"):
        incremental_product(repo, ProductRequest(kind="qvp"), device="cpu")
    # the mosaic arm takes a catalog (tests/test_torch_mosaic.py holds its
    # state against the reference's): an empty one has nothing to mosaic
    class EmptyCatalog:
        def entries(self):
            return {}

    with pytest.raises(ValueError, match="no repositories to mosaic"):
        incremental_product(EmptyCatalog(), ProductRequest(kind="mosaic"),
                            device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("cappi", "column_max", "qpe"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            incremental_product(repo, ProductRequest(kind=kind))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            incremental_product(repo, ProductRequest(kind=kind),
                                device="cuda")
