"""``grid_map`` over several sweeps in one call, and its cell order, on the CPU.

* The plain version over S sweeps (``repro_torch.kernels.ref.grid_map``
  with a (C, S, k) map) against the reference oracle
  ``repro.kernels.ref.grid_map`` per sweep, then ``np.fmax.reduce``,
  **bitwise**: NaN gates, zero weights, out-of-range and negative
  indices, cells out of every sweep's reach, k = 1 and 4, S = 1 and 5;
  the same in the kernel's order (a ``CellOrder``).
* ``kernels.grid_map.cell_order``: a permutation, the live cells first,
  8 x 8 tiles of the grid one after another, the dead ones as its tail;
  ``CellOrder`` rejects what is not a permutation, and the plain version
  an order of another length or a live row in the dead tail.
* ``radar.grid.device_map``: the cached device copy of the maps in that
  order, one per (mappings, width, device).
* Column-max and incremental column-max through both packages'
  ``compute_product`` / ``incremental_product``: bitwise equal, with the
  same chunk fetches.
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
from repro.radar import incremental_product as ref_incremental  # noqa: E402
from repro.radar.products import ProductRequest as RefRequest  # noqa: E402
from repro.radar.products import compute_product as ref_compute  # noqa: E402
from repro.store import ObjectStore as RefObjectStore  # noqa: E402
from repro.store import Repository as RefRepository  # noqa: E402
from repro_torch.core import RadarArchive, fm301  # noqa: E402
from repro_torch.etl import StormSimulator  # noqa: E402
from repro_torch.kernels import grid_map as gm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.radar import (CartesianGrid, ProductRequest,  # noqa: E402
                               compute_product, incremental_product)
from repro_torch.radar import grid  # noqa: E402
from repro_torch.store import Repository  # noqa: E402

VCP = "VCP-212"
T0 = 1305849600.0
N_BASE, N_APPEND, SEED = 6, 2, 5
GEOMETRY = dict(n_az=72, n_gates=200, n_sweeps=3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_bitwise(got, want):
    """Equal shapes, NaN in the same places, every other value equal bit
    for bit."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    assert got[~nan_g].tobytes() == want[~nan_w].tobytes()


def _sweeps_case(t, g, c, s, k, seed):
    """S fields and a (C, S, k) map with every hazard: NaN gates, zero
    weights, indices past the end and negative, a few cells out of every
    sweep's reach, and some out of one sweep's reach only."""
    rng = np.random.default_rng(seed)
    fields = rng.normal(20.0, 12.0, size=(s, t, g)).astype(np.float32)
    fields[rng.random((s, t, g)) < 0.2] = np.nan
    idx = rng.integers(-g - 5, g + 5, size=(c, s, k)).astype(np.int32)
    w = (1.0 / rng.uniform(1.0, 3e5, size=(c, s, k)) ** 2).astype(np.float32)
    w[rng.random((c, s, k)) < 0.3] = 0.0
    w[rng.random(c) < 0.15] = 0.0                       # out of every reach
    w[rng.random((c, s)) < 0.2] = 0.0                   # out of one sweep's
    return fields, idx, w


def _oracle(fields, idx, w):
    """The reference's column-max: its oracle per sweep, then fmax."""
    per = [np.asarray(jref.grid_map(fields[s], idx[:, s], w[:, s]))
           for s in range(idx.shape[1])]
    return np.fmax.reduce(np.stack(per, axis=0), axis=0)


# (T, G, ny, nx, S, k, seed): C = ny * nx cells
CASES = [(1, 50, 5, 8, 1, 1, 0), (4, 301, 7, 11, 1, 4, 1),
         (3, 400, 13, 23, 5, 1, 2), (5, 257, 10, 13, 5, 4, 3),
         (1, 1000, 27, 19, 5, 1, 4), (2, 64, 15, 20, 5, 4, 5)]


@pytest.mark.parametrize("t, g, ny, nx, s, k, seed", CASES)
def test_multi_sweep_plain_matches_oracle_then_fmax_bitwise(t, g, ny, nx, s,
                                                            k, seed):
    fields, idx, w = _sweeps_case(t, g, ny * nx, s, k, seed)
    want = _oracle(fields, idx, w)
    got = ref.grid_map([_t(f) for f in fields], _t(idx), _t(w)).numpy()
    assert_bitwise(got, want)
    assert np.isnan(got).any() and np.isfinite(got).any()


@pytest.mark.parametrize("t, g, ny, nx, s, k, seed", CASES)
def test_kernel_order_gives_the_same_bits(t, g, ny, nx, s, k, seed):
    fields, idx, w = _sweeps_case(t, g, ny * nx, s, k, seed)
    order, n_live = gm.cell_order(idx, w, g, (ny, nx))
    got = ops.grid_map([_t(f) for f in fields], _t(idx[order]),
                       _t(w[order]),
                       order=gm.CellOrder(_t(order.astype(np.int32)), n_live))
    assert_bitwise(got.numpy(), _oracle(fields, idx, w))


def test_one_sweep_map_of_either_rank_is_the_single_field_call():
    fields, idx, w = _sweeps_case(3, 300, 100, 1, 4, 6)
    two_d = ref.grid_map(_t(fields[0]), _t(idx[:, 0]), _t(w[:, 0]))
    three_d = ref.grid_map([_t(fields[0])], _t(idx), _t(w))
    assert_bitwise(two_d.numpy(), three_d.numpy())
    assert_bitwise(two_d.numpy(), np.asarray(
        jref.grid_map(fields[0], idx[:, 0], w[:, 0])))


@pytest.mark.parametrize("ny, nx, s, k, seed", [(30, 30, 1, 1, 7),
                                                (19, 45, 1, 4, 8),
                                                (33, 17, 5, 1, 9),
                                                (8, 8, 3, 4, 10),
                                                (1, 300, 5, 1, 11)])
def test_cell_order_is_live_cells_tile_by_tile_then_dead_tail(ny, nx, s, k,
                                                              seed):
    g, c = 700, ny * nx
    _, idx, w = _sweeps_case(1, g, c, s, k, seed)
    order, n_live = gm.cell_order(idx, w, g, (ny, nx))
    assert sorted(order.tolist()) == list(range(c))
    live = ref.live_slots(_t(idx), _t(w), g).reshape(c, -1).any(1).numpy()
    assert n_live == int(live.sum()) and 0 < n_live < c
    assert live[order[:n_live]].all() and not live[order[n_live:]].any()
    # the dead tail in cell order; the live cells tile by tile (8 x 8,
    # tiles row by row), each tile's cells row by row
    assert np.all(np.diff(order[n_live:]) > 0)
    want = [y * nx + x
            for ty in range(0, ny, gm.TILE) for tx in range(0, nx, gm.TILE)
            for y in range(ty, min(ty + gm.TILE, ny))
            for x in range(tx, min(tx + gm.TILE, nx))
            if live[y * nx + x]]
    assert order[:n_live].tolist() == want


def test_cell_order_of_an_empty_map_is_all_dead():
    order, n_live = gm.cell_order(np.zeros((5, 0), np.int32),
                                  np.zeros((5, 0), np.float32), 10, (1, 5))
    assert n_live == 0 and order.tolist() == list(range(5))
    with pytest.raises(ValueError, match="raster"):
        gm.cell_order(np.zeros((5, 1), np.int32),
                      np.zeros((5, 1), np.float32), 10, (2, 3))


@pytest.mark.parametrize("t, k, rows", [(64, 1, 1), (64, 4, 8), (5, 4, 4),
                                        (3, 4, 2), (1, 4, 1), (1, 1, 1),
                                        (0, 4, 1)])
def test_rows_per_thread(t, k, rows):
    assert gm.rows_per_thread(t, k) == rows
    assert rows in gm.ROWS_CHOICES


def test_plain_version_rejects_a_bad_order_or_live_tail():
    fields, idx, w = _sweeps_case(2, 300, 50, 2, 1, 11)
    f = [_t(x) for x in fields]
    order, n_live = gm.cell_order(idx, w, 300, (5, 10))
    io, wo = _t(idx[order]), _t(w[order])
    cells = _t(order.astype(np.int32))
    with pytest.raises(ValueError, match="permutation"):
        gm.CellOrder(cells.clone().fill_(0), n_live)
    with pytest.raises(ValueError, match="50 map rows"):
        ref.grid_map(f, io, wo, order=gm.CellOrder(
            _t(np.arange(49, dtype=np.int32)), n_live))
    with pytest.raises(ValueError, match="no live slot"):
        ref.grid_map(f, io, wo, order=gm.CellOrder(cells, n_live - 1))
    with pytest.raises(ValueError, match="fields"):
        ref.grid_map(f[:1], io, wo)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.grid_map(f, io, wo, order=gm.CellOrder(cells, n_live),
                     mode="kernel")


@pytest.mark.parametrize("cells, n_live, match", [
    ([0, 1, 2, 5], 4, "permutation"),            # past the last column
    ([0, -1, 2, 3], 4, "permutation"),           # negative
    ([0, 1, 1, 3], 4, "permutation"),            # one column twice
    ([3, 2, 1, 0], 5, "n_live"),
    ([3, 2, 1, 0], -1, "n_live")])
def test_cell_order_rejects_what_the_kernel_would_misuse(cells, n_live,
                                                         match):
    """The kernel writes row i to column cells[i]: an entry out of range,
    or one column twice, is refused when the order is made."""
    with pytest.raises(ValueError, match=match):
        gm.CellOrder(torch.tensor(cells, dtype=torch.int32), n_live)
    with pytest.raises(ValueError, match="int32"):
        gm.CellOrder(torch.tensor([1, 0]), 2)
    ok = gm.CellOrder(torch.tensor([3, 2, 1, 0], dtype=torch.int32), 2)
    assert ok.n_live == 2
    # a meta tensor holds no values: only its shape and dtype are checked
    gm.CellOrder(torch.empty(4, dtype=torch.int32, device="meta"), 4)


# ---------------------------------------------------------------------------
# The device map cache
# ---------------------------------------------------------------------------


def _sweep_maps(elevs=(0.5, 1.3, 19.5), method="nearest", n=14):
    az = (np.arange(72, dtype=np.float64) + 0.5) * 5.0
    rng_m = (np.arange(200, dtype=np.float64) + 0.5) * 250.0
    g = CartesianGrid.around(36.74, -98.13, 50e3, n, n + 2)
    return [grid.build_mapping(36.74, -98.13, az, rng_m, e, g, method=method)
            for e in elevs]


@pytest.mark.parametrize("method", ["nearest", "idw"])
def test_device_map_is_the_stacked_map_in_gate_order(method):
    grid.clear_mapping_cache()
    maps = _sweep_maps(method=method)
    dm = grid.device_map(maps, 72 * 200, "cpu")
    stacked_i = np.stack([m.gate_idx for m in maps], axis=1)
    stacked_w = np.stack([m.weights for m in maps], axis=1)
    g = maps[0].grid
    order, n_live = gm.cell_order(stacked_i, stacked_w, 72 * 200,
                                  (g.ny, g.nx))
    cells = dm.order.cells
    assert dm.order.n_live == n_live
    assert cells.dtype == torch.int32 and dm.gate_idx.dtype == torch.int32
    assert np.array_equal(cells.numpy(), order)
    assert np.array_equal(dm.gate_idx.numpy(), stacked_i[order])
    assert np.array_equal(dm.weights.numpy(), stacked_w[order])
    # the live rows are the cells in reach of some sweep
    reach = np.logical_or.reduce([m.in_reach() for m in maps])
    assert np.array_equal(np.sort(cells.numpy()[:n_live]),
                          np.flatnonzero(reach))


def test_device_map_cache_hits_per_mappings_width_and_device():
    grid.clear_mapping_cache()
    maps = _sweep_maps()
    first = grid.device_map(maps, 72 * 200, "cpu")
    again = grid.device_map(_sweep_maps(), 72 * 200, torch.device("cpu"))
    assert again is first
    assert again.gate_idx is first.gate_idx and again.order is first.order
    # another device, width or set of mappings gets its own
    meta = grid.device_map(maps, 72 * 200, "meta")
    assert meta is not first and meta.gate_idx.device.type == "meta"
    assert grid.device_map(maps, 72 * 200 * 2, "cpu") is not first
    other = grid.device_map(maps[:2], 72 * 200, "cpu")
    assert other is not first and other.gate_idx.shape[1] == 2
    assert grid.device_map(_sweep_maps(n=15), 72 * 200, "cpu") is not first
    assert grid.device_map(maps, 72 * 200, "cpu") is first
    # a mapping built by hand has no cache key and is not cached
    hand = grid.GridMapping(maps[0].grid, np.array(maps[0].gate_idx),
                            np.array(maps[0].weights), 72, 200, "nearest",
                            0.5)
    assert grid.device_map([hand], 72 * 200, "cpu") is not \
        grid.device_map([hand], 72 * 200, "cpu")
    grid.clear_mapping_cache()
    assert grid.device_map(maps, 72 * 200, "cpu") is not first


# ---------------------------------------------------------------------------
# Column-max, full and incremental, against the reference package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    raw = RefObjectStore(str(tmp_path_factory.mktemp("raw")))
    generate_raw_archive(raw, n_scans=N_BASE, seed=SEED, **GEOMETRY)
    path = str(tmp_path_factory.mktemp("repo"))
    ingest(raw, RefRepository.create(path), batch_size=3, time_chunk=2)
    return path


@pytest.mark.parametrize("method, ny, nx, time_slice", [
    ("nearest", 30, 34, None), ("idw", 26, 22, (1, 5))])
def test_column_max_one_launch_matches_reference(archive, method, ny, nx,
                                                 time_slice, monkeypatch):
    calls = []
    plain = ref.grid_map

    def counted(*a, **kw):
        calls.append(len(a[0]))
        return plain(*a, **kw)

    monkeypatch.setattr(ref, "grid_map", counted)
    req = dict(kind="column_max", vcp=VCP, method=method, ny=ny, nx=nx,
               time_slice=time_slice)
    session = RefRepository.open(archive).readonly_session()
    try:
        want = ref_compute(session, RefRequest(**req))
    finally:
        session.close()
    with Repository.open(archive).readonly_session() as session:
        got = compute_product(session, ProductRequest(**req), device="cpu")
    # one call of the plain version over the three sweeps
    assert calls == [GEOMETRY["n_sweeps"]]
    assert_bitwise(got.values, want.values)
    assert got.times.tobytes() == want.times.tobytes()
    assert got.params == want.params
    assert got.chunk_fetches == want.chunk_fetches > 0


def _appended(who):
    fm, sim = ((ref_fm301, RefSimulator(seed=SEED)) if who == "ref"
               else (fm301, StormSimulator(seed=SEED)))
    full = fm.VCPS[VCP]
    vcp = fm.VCPDef(full.vcp_id, full.elevations[:GEOMETRY["n_sweeps"]],
                    GEOMETRY["n_az"], GEOMETRY["n_gates"], full.gate_m,
                    full.interval_s)
    return [sim.volume(fm.SITES["KVNX"], vcp,
                       T0 + (N_BASE + i) * vcp.interval_s)
            for i in range(N_APPEND)]


@pytest.mark.parametrize("method", ["nearest", "idw"])
def test_incremental_column_max_one_launch_matches_reference(
        archive, tmp_path, method, monkeypatch):
    paths = {}
    for who in ("ref", "port"):
        paths[who] = str(tmp_path / who)
        shutil.copytree(archive, paths[who])
    ref_repo, repo = (RefRepository.open(paths["ref"]),
                      Repository.open(paths["port"]))
    req = dict(kind="column_max", ny=20, nx=24, method=method)
    want_inc = ref_incremental(ref_repo, RefRequest(**req))
    inc = incremental_product(repo, ProductRequest(**req), device="cpu")
    calls = []
    plain = ref.grid_map

    def counted(*a, **kw):
        calls.append(len(a[0]))
        return plain(*a, **kw)

    monkeypatch.setattr(ref, "grid_map", counted)
    scatters = []
    monkeypatch.setattr(ops, "grid_scatter_",
                        lambda *a, **kw: scatters.append(a))
    volumes = {"ref": _appended("ref"), "port": _appended("port")}
    for step in range(N_APPEND + 1):
        if step:
            RefArchive(ref_repo).append_scan(volumes["ref"][step - 1])
            RadarArchive(repo).append_scan(volumes["port"][step - 1])
        del calls[:]
        rep, want_rep = inc.update(), want_inc.update()
        # one regrid over every sweep, and no scatter
        assert calls == [GEOMETRY["n_sweeps"]] and not scatters
        assert (rep.n_new_scans, rep.cells_computed, rep.cells_full,
                rep.chunk_fetches) == (want_rep.n_new_scans,
                                       want_rep.cells_computed,
                                       want_rep.cells_full,
                                       want_rep.chunk_fetches)
        assert rep.snapshot_id == want_rep.snapshot_id
        state, want = inc.read(), want_inc.read()
        assert state.values.tobytes() == want.values.tobytes()
        assert state.times.tobytes() == want.times.tobytes()
