"""The in-place scatter ``grid_update`` and the one-exponential ``zr_accum``
on the CPU, against the reference package.

* ``repro_torch.kernels.ref.grid_scatter_`` (the plain version of the
  in-place scatter of ``csrc/grid_update.cu``) against the reference
  oracle ``repro.kernels.ref.grid_update`` and the Pallas kernel in
  interpret mode, given the equivalent ``pos`` map, **bitwise**.
* The port's sparse QPE fold (``radar.incremental._fold_terms``, one
  in-place scatter per wet scan) against its dense fold and against the
  reference's ``_fold_terms``, bitwise.
* ``repro_torch.kernels.ref.zr_accum_exp2`` (the rewritten kernel's
  formula, ``R = 2 ** (dc * k1 - k0)``) within the kernel tests'
  tolerance of ``repro.kernels.ref.zr_accum``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.grid_update import grid_update_pallas  # noqa: E402
from repro.radar import incremental as ref_incremental  # noqa: E402
from repro_torch.kernels import grid_update, ops, ref  # noqa: E402
from repro_torch.radar import incremental  # noqa: E402

QPE_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py, zr_accum
T0 = 1305849600.0


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _scatter_case(t, c, m, seed):
    """A (t, c) state with NaNs, m ascending cells and their (t, m)
    update block (NaNs too), and the equivalent pos map."""
    rng = np.random.default_rng(seed)
    state = rng.normal(20.0, 12.0, size=(t, c)).astype(np.float32)
    state[rng.random((t, c)) < 0.2] = np.nan
    cells = np.sort(rng.choice(c, size=m, replace=False)).astype(np.int32)
    upd = rng.normal(20.0, 12.0, size=(t, m)).astype(np.float32)
    upd[rng.random((t, m)) < 0.2] = np.nan
    pos = np.full(c, -1, np.int32)
    pos[cells] = np.arange(m, dtype=np.int32)
    return state, upd, cells, pos


SCATTER_CASES = [(1, 1, 1, 0), (1, 3000, 39, 1), (3, 1777, 900, 2),
                 (3, 2999, 2999, 3), (1, 256, 0, 4), (3, 513, 0, 5),
                 (1, 5003, 1, 6)]


@pytest.mark.parametrize("op", ["set", "add", "max"])
@pytest.mark.parametrize("t, c, m, seed", SCATTER_CASES)
def test_scatter_matches_oracle_and_pallas_bitwise(t, c, m, seed, op):
    state, upd, cells, pos = _scatter_case(t, c, m, seed)
    patched = _t(state.copy())
    out = ref.grid_scatter_(patched, _t(upd), _t(cells), op=op)
    assert out is patched                       # in place
    got = out.numpy()
    want = np.asarray(jref.grid_update(state, upd, pos, op=op))
    assert got.tobytes() == want.tobytes()
    pallas = grid_update_pallas(state, upd, pos, op=op, bt=4, bc=256,
                                interpret=True)
    assert got.tobytes() == np.asarray(pallas).tobytes()
    # and the port's plain copy of the reference's function on that map
    dense = ref.grid_update(_t(state), _t(upd), _t(pos), op=op).numpy()
    assert got.tobytes() == dense.tobytes()


@pytest.mark.parametrize("op", ["set", "add", "max"])
def test_scatter_leaves_untouched_cells_bitwise(op):
    state, upd, cells, _ = _scatter_case(3, 2000, 300, 9)
    state[:, ::7] = np.nan
    patched = ref.grid_scatter_(_t(state.copy()), _t(upd), _t(cells),
                                op=op).numpy()
    keep = np.ones(state.shape[1], bool)
    keep[cells] = False
    assert patched[:, keep].tobytes() == state[:, keep].tobytes()
    n_nan = np.isnan(state[:, keep]).sum()
    assert np.isnan(patched[:, keep]).sum() == n_nan > 0


@pytest.mark.parametrize("cells", [[0, 2, 2], [3, 1], [-1, 2], [1, 5],
                                   [4, 4]])
def test_scatter_rejects_cells_not_increasing_or_out_of_range(cells):
    state = torch.zeros(2, 5)
    upd = torch.ones(2, len(cells))
    with pytest.raises(ValueError, match="strictly increasing"):
        ref.grid_scatter_(state, upd, torch.tensor(cells, dtype=torch.int32))
    with pytest.raises(ValueError, match="strictly increasing"):
        ops.grid_scatter_(state, upd, torch.tensor(cells, dtype=torch.int32))
    assert torch.equal(state, torch.zeros(2, 5))


def test_scatter_rejects_bad_op_shape_and_dtype():
    state = torch.zeros(2, 5)
    cells = torch.tensor([1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown grid_update op"):
        ops.grid_scatter_(state, torch.ones(2, 2), cells, op="mul")
    with pytest.raises(ValueError, match="need upd"):
        ref.grid_scatter_(state, torch.ones(2, 3), cells)
    with pytest.raises(TypeError, match="float32"):
        ref.grid_scatter_(state.double(), torch.ones(2, 2), cells)


def test_scatter_kernel_mode_on_cpu_raises_and_auto_launches_nothing():
    state, upd, cells, _ = _scatter_case(3, 400, 50, 11)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.grid_scatter_(_t(state.copy()), _t(upd), _t(cells), op="add",
                          mode="kernel")
    before = grid_update.launches
    got = ops.grid_scatter_(_t(state.copy()), _t(upd), _t(cells), op="add")
    assert grid_update.launches == before
    want = ref.grid_scatter_(_t(state.copy()), _t(upd), _t(cells), op="add")
    assert got.numpy().tobytes() == want.numpy().tobytes()


def _fold_inputs(seed, shape=(6, 24, 50)):
    rng = np.random.default_rng(seed)
    dbz = rng.normal(8.0, 15.0, size=shape).astype(np.float32)
    dbz[3] = -10.0                     # a dry scan
    dbz[rng.random(shape) < 0.1] = np.nan
    dbz[0, 0, :4] = [np.inf, -np.inf, 53.5, 5.0]
    rates = incremental._zr_rate_rows(dbz, a=200.0, b=1.6)
    dt = incremental._rect_dt(T0 + 270.0 * np.arange(shape[0]), None)
    start = np.abs(rng.normal(size=shape[1] * shape[2])).astype(np.float32)
    return rates, dt, start


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_fold_equals_dense_and_reference_bitwise(seed):
    rates, dt, start = _fold_inputs(seed)
    sparse, n_sparse = incremental._fold_terms(start, rates, dt, sparse=True,
                                               device="cpu")
    dense, n_dense = incremental._fold_terms(start, rates, dt)
    want_sparse, n_ref = ref_incremental._fold_terms(start, rates, dt,
                                                     sparse=True)
    want_dense, _ = ref_incremental._fold_terms(start, rates, dt)
    assert sparse.tobytes() == dense.tobytes() == want_sparse.tobytes() \
        == want_dense.tobytes()
    assert n_sparse == n_ref == int((rates > 0).sum()) < n_dense


def test_sparse_fold_scatters_once_per_wet_scan_and_never_dense(monkeypatch):
    """One in-place scatter per wet scan, in scan order, with ascending
    cells, into the one (1, C) state: no (C,) pos map and no fresh state
    per scan."""
    rates, dt, start = _fold_inputs(4)
    calls = []
    plain = ops.grid_scatter_

    def spy(state, upd, cells, *, op, mode="auto"):
        calls.append((tuple(state.shape), upd.shape[1], op,
                      bool((cells[1:] > cells[:-1]).all())))
        return plain(state, upd, cells, op=op, mode=mode)

    monkeypatch.setattr(ops, "grid_scatter_", spy)
    got, touched = incremental._fold_terms(start, rates, dt, sparse=True,
                                           device="cpu")
    wet = [int((rates[i] > 0).sum()) for i in range(rates.shape[0])]
    assert [n for _, n, _, _ in calls] == [n for n in wet if n]
    assert len(calls) == rates.shape[0] - 1          # scan 3 is dry
    assert all(s == (1, start.size) and op == "add" and ascending
               for s, _, op, ascending in calls)
    assert touched == sum(wet)
    dense, _ = incremental._fold_terms(start, rates, dt)
    assert got.tobytes() == dense.tobytes()


def test_sparse_fold_of_dry_scans_returns_the_state():
    rates = np.zeros((3, 40), np.float32)
    start = np.arange(40, dtype=np.float32)
    got, touched = incremental._fold_terms(
        start, rates, np.full(3, 300.0, np.float32), sparse=True,
        device="cpu")
    assert touched == 0 and got.tobytes() == start.tobytes()


def _dbz_sweep():
    """Every 1e-4 dBZ over [-30, 80] (1.1 M values), with NaN and +-inf,
    as one (1, 1, n) scan."""
    x = np.arange(-30.0, 80.0 + 1e-9, 1e-4).astype(np.float32)
    x = np.concatenate([x, np.array([np.nan, np.inf, -np.inf, 5.0,
                                     53.0], np.float32)])
    return x.reshape(1, 1, -1)


@pytest.mark.parametrize("a, b", [(200.0, 1.6), (300.0, 1.4)])
def test_zr_accum_exp2_matches_reference_over_a_dbz_sweep(a, b):
    dbz = _dbz_sweep()
    dt = np.array([300.0], np.float32)
    got = ref.zr_accum_exp2(_t(dbz), _t(dt), a=a, b=b).numpy()
    want = np.asarray(jref.zr_accum(dbz, dt, a=a, b=b))
    np.testing.assert_allclose(got, want, **QPE_TOL)
    assert np.isfinite(got).all()
    # non-finite and below-threshold gates add exactly 0
    bad = ~np.isfinite(dbz[0]) | (dbz[0] < 5.0)
    assert (got[bad] == 0.0).all() and (got[~bad] > 0.0).all()
    # relative error of the clipped range: far inside the tolerance
    wet = ~bad
    rel = np.abs(got[wet] / want[wet] - 1.0).max()
    assert rel < 1e-5


def test_zr_accum_exp2_matches_reference_over_time():
    rng = np.random.default_rng(5)
    dbz = rng.normal(20.0, 12.0, size=(9, 17, 61)).astype(np.float32)
    dbz[rng.random(dbz.shape) < 0.15] = np.nan
    dt = rng.uniform(200.0, 400.0, size=9).astype(np.float32)
    got = ref.zr_accum_exp2(_t(dbz), _t(dt)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.zr_accum(dbz, dt)),
                               **QPE_TOL)
    np.testing.assert_allclose(got, ops.zr_accum(_t(dbz), _t(dt)).numpy(),
                               **QPE_TOL)


def test_zr_accum_exp2_known_value_and_constants():
    """40 dBZ for one hour under Marshall-Palmer ~ 11.53 mm."""
    out = ref.zr_accum_exp2(_t(np.full((1, 1, 1), 40.0, np.float32)),
                            _t(np.array([3600.0], np.float32)))
    expected = (1e4 / 200.0) ** (1 / 1.6)
    np.testing.assert_allclose(out.numpy()[0, 0], expected, rtol=1e-4)
    k1, k0 = ref.zr_exp2_constants(200.0, 1.6)
    inv_b = float(np.float32(1 / 1.6))
    assert k1 == float(np.float32(inv_b * np.log2(10.0) / 10.0))
    assert k0 == float(np.float32(inv_b * np.log2(200.0)))
    with pytest.raises(ValueError, match="a > 0"):
        ref.zr_exp2_constants(0.0, 1.6)
