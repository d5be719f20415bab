"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device (the kernels have no CPU or interpret
mode): they carry the ``cuda`` marker and skip without one.  The file
imports nothing of JAX, so it runs where the GPU is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (grid_map, grid_update, ops,  # noqa: E402
                                 qvp_reduce, zr_accum)
from repro_torch.kernels import ref  # noqa: E402

QVP_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels.py, qvp_reduce
QPE_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py, zr_accum


def _radar_field(rng, t, a, r, nan_frac=0.15):
    f = rng.normal(20.0, 12.0, size=(t, a, r)).astype(np.float32)
    f[rng.random((t, a, r)) < nan_frac] = np.nan
    return f


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 37, 77), (3, 720, 1193), (1, 9, 1)])
def test_qvp_reduce_kernel_matches_plain_on_card(shape):
    _need_cuda()
    rng = np.random.default_rng(7)
    field = _t(_radar_field(rng, *shape)).cuda()
    quality = _t(rng.uniform(0.5, 1.0, size=shape).astype(np.float32)).cuda()
    before = qvp_reduce.launches
    got = ops.qvp_reduce(field, quality)
    assert qvp_reduce.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.qvp_reduce(field, quality).cpu(),
                               **QVP_TOL)
    again = ops.qvp_reduce(field, quality)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 13, 301), (2, 720, 1193), (1, 1, 1)])
def test_zr_accum_kernel_matches_plain_on_card(shape):
    _need_cuda()
    rng = np.random.default_rng(8)
    dbz = _t(_radar_field(rng, *shape)).cuda()
    dt_s = _t(rng.uniform(200.0, 400.0, size=shape[:1]).astype(np.float32)).cuda()
    before = zr_accum.launches
    got = ops.zr_accum(dbz, dt_s)
    assert zr_accum.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.zr_accum(dbz, dt_s).cpu(), **QPE_TOL)
    again = ops.zr_accum(dbz, dt_s)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _bits_equal(a, b):
    """Same NaN places, every other value equal bit for bit."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("t, g, c, k", [(1, 8, 1, 1), (5, 3001, 777, 1),
                                        (3, 4000, 2999, 4), (7, 640, 1000, 8),
                                        (2, 1000, 513, 11), (4, 300, 200, 0)])
def test_grid_map_kernel_matches_plain_on_card_bitwise(t, g, c, k):
    _need_cuda()
    rng = np.random.default_rng(9 + k)
    field = rng.normal(20.0, 12.0, size=(t, g)).astype(np.float32)
    field[rng.random((t, g)) < 0.2] = np.nan
    # in range, plus indices >= G and negative ones (jnp.take's rule)
    idx = rng.integers(-g - 5, g + 5, size=(c, k)).astype(np.int32)
    w = (1.0 / rng.uniform(1.0, 3e5, size=(c, k)) ** 2).astype(np.float32)
    w[rng.random((c, k)) < 0.3] = 0.0
    field, idx, w = _t(field).cuda(), _t(idx).cuda(), _t(w).cuda()
    before = grid_map.launches
    got = ops.grid_map(field, idx, w)
    assert grid_map.launches == before + 1
    assert _bits_equal(got, ref.grid_map(field, idx, w))
    again = ops.grid_map(field, idx, w)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    # empty axes: an all-NaN (T, C) without a launch
    empty = ops.grid_map(field[:0], idx, w)
    assert tuple(empty.shape) == (0, c) and grid_map.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["set", "add", "max"])
@pytest.mark.parametrize("t, c, frac", [(1, 1, 1.0), (1, 57600, 0.3),
                                        (9, 1777, 0.5), (3, 2999, 0.0)])
def test_grid_update_kernel_matches_plain_on_card_bitwise(t, c, frac, op):
    _need_cuda()
    rng = np.random.default_rng(c)
    state = rng.normal(20.0, 12.0, size=(t, c)).astype(np.float32)
    state[rng.random((t, c)) < 0.2] = np.nan
    touched = rng.random(c) < frac
    m = int(touched.sum())
    pos = np.full(c, -1, np.int32)
    pos[touched] = rng.permutation(m).astype(np.int32)
    if m:
        pos[np.flatnonzero(touched)[0]] = m + 1     # reads NaN
    upd = rng.normal(20.0, 12.0, size=(t, max(m, 1))).astype(np.float32)
    state, upd, pos = _t(state).cuda(), _t(upd).cuda(), _t(pos).cuda()
    before = grid_update.launches
    got = ops.grid_update(state, upd, pos, op=op)
    assert grid_update.launches == before + 1
    assert _bits_equal(got, ref.grid_update(state, upd, pos, op=op))
    untouched = (pos < 0).cpu()
    assert torch.equal(got.cpu()[:, untouched].view(torch.int32),
                       state.cpu()[:, untouched].view(torch.int32))
    again = ops.grid_update(state, upd, pos, op=op)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    with pytest.raises(ValueError, match="unknown grid_update op"):
        ops.grid_update(state, upd, pos, op="mul")
