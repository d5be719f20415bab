"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device (the kernels have no CPU or interpret
mode): they carry the ``cuda`` marker and skip without one.  The file
imports nothing of JAX, so it runs where the GPU is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (flash_attention, grid_map,  # noqa: E402
                                 grid_update, mamba2_scan, ops, qvp_reduce,
                                 zr_accum)
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


def _sweeps_case(rng, t, g, c, s, k):
    fields = rng.normal(20.0, 12.0, size=(s, t, g)).astype(np.float32)
    fields[rng.random((s, t, g)) < 0.2] = np.nan
    idx = rng.integers(-g - 5, g + 5, size=(c, s, k)).astype(np.int32)
    w = rng.uniform(0.0, 2.0, size=(c, s, k)).astype(np.float32)
    w[rng.random((c, s, k)) < 0.3] = 0.0
    w[rng.random(c) < 0.2] = 0.0                 # out of every sweep's reach
    return fields, idx, w


@pytest.mark.cuda
@pytest.mark.parametrize("t, g, ny, nx, s, k", [(5, 3001, 21, 37, 5, 1),
                                               (3, 4000, 51, 59, 3, 4),
                                               (1, 1000, 19, 27, 5, 1),
                                               (2, 1000, 27, 19, 2, 11),
                                               (9, 640, 25, 40, 5, 4),
                                               (5, 700, 13, 17, 2, 4),
                                               (64, 2000, 28, 25, 1, 1)])
def test_grid_map_kernel_several_sweeps_in_tile_order_bitwise(t, g, ny, nx,
                                                              s, k):
    """One launch over S sweeps, rows in the kernel's order (8 x 8 tiles,
    the dead rows a tail): bitwise the plain version over the map in grid
    order; the cases take 1, 2, 4 and 8 rows a thread."""
    _need_cuda()
    rng = np.random.default_rng(t * 1000 + s * 10 + k)
    fields, idx, w = _sweeps_case(rng, t, g, ny * nx, s, k)
    order, n_live = grid_map.cell_order(idx, w, g, (ny, nx))
    f = [_t(x).cuda() for x in fields]
    want = ref.grid_map(f, _t(idx).cuda(), _t(w).cuda())
    io, wo = _t(idx[order]).cuda(), _t(w[order]).cuda()
    cells = _t(order.astype(np.int32)).cuda()
    before = grid_map.launches
    got = grid_map.grid_map_cuda(f, io, wo, cells, n_live)
    assert grid_map.launches == before + 1
    assert _bits_equal(got, want)
    again = grid_map.grid_map_cuda(f, io, wo, cells, n_live)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert _bits_equal(ops.grid_map(f, io, wo, order=grid_map.CellOrder(
        cells, n_live)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [777, 2**31 - 1, -1, -2**31])
def test_grid_map_kernel_skips_cells_out_of_range(bad):
    """A row whose output column falls outside [0, C) (C = 777 here)
    writes nothing: the launch neither faults nor changes another column.
    ``CellOrder`` refuses such a list before ``ops.grid_map`` sees it."""
    _need_cuda()
    rng = np.random.default_rng(23)
    t, g, c, s, k = 5, 3001, 777, 2, 4
    fields, idx, w = _sweeps_case(rng, t, g, c, s, k)
    f = [_t(x).cuda() for x in fields]
    io, wo = _t(idx).cuda(), _t(w).cuda()
    want = ref.grid_map(f, io, wo)
    cells = torch.arange(c, dtype=torch.int32)
    bad_rows = [3, 400, c - 1]
    cells[bad_rows] = bad
    got = grid_map.grid_map_cuda(f, io, wo, cells.cuda(), c)
    torch.cuda.synchronize()
    keep = torch.ones(c, dtype=torch.bool)
    keep[bad_rows] = False
    keep = keep.cuda()
    assert _bits_equal(got[:, keep], want[:, keep])
    with pytest.raises(ValueError, match="permutation"):
        grid_map.CellOrder(cells.cuda(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nearest", "idw"])
def test_grid_map_fused_column_max_matches_five_launches_bitwise(method):
    """Column-max's five VCP-212 sweeps (the archive's geometry) in one
    launch from the cached device map, against the plain version and
    against five one-sweep launches folded by torch.fmax."""
    _need_cuda()
    from repro_torch.radar import grid

    a, r = 720, 1192
    az = (np.arange(a) + 0.5) * (360.0 / a)
    rng_m = (np.arange(r) + 0.5) * 250.0
    elevs = (0.5, 0.9, 1.3, 1.8, 19.5)
    g = grid._default_grid(36.74, -98.13, rng_m, elevs, 240, 240)
    maps = [grid.build_mapping(36.74, -98.13, az, rng_m, e, g, method=method)
            for e in elevs]
    rng = np.random.default_rng(19)
    f = [_t(_radar_field(rng, 4, a, r).reshape(4, a * r)).cuda()
         for _ in elevs]
    dm = grid.device_map(maps, a * r, f[0].device)
    before = grid_map.launches
    got = ops.grid_map(f, dm.gate_idx, dm.weights, order=dm.order)
    assert grid_map.launches == before + 1
    idx = _t(np.stack([m.gate_idx for m in maps], 1)).cuda()
    w = _t(np.stack([m.weights for m in maps], 1)).cuda()
    assert _bits_equal(got, ref.grid_map(f, idx, w))
    split = None
    for s in range(len(elevs)):
        y = ops.grid_map(f[s], idx[:, s].contiguous(), w[:, s].contiguous())
        split = y if split is None else torch.fmax(split, y)
    assert _bits_equal(got, split)
    # the incremental paths' call: one new row through the whole map
    one = [x[:1].contiguous() for x in f]
    row = ops.grid_map(one, dm.gate_idx, dm.weights, order=dm.order)
    assert _bits_equal(row, got[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["set", "add", "max"])
@pytest.mark.parametrize("t, c, frac", [(1, 1, 1.0), (1, 57600, 0.79),
                                        (1, 858240, 0.89), (1, 858240, 0.013),
                                        (9, 1777, 0.5), (3, 2999, 0.0),
                                        (1, 4001, 1e-4)])
def test_grid_update_kernel_matches_plain_on_card_bitwise(t, c, frac, op):
    """The in-place scatter kernel against its plain version and against
    the reference's pos-mapped function with the equivalent map."""
    _need_cuda()
    rng = np.random.default_rng(c + 1)
    state = rng.normal(20.0, 12.0, size=(t, c)).astype(np.float32)
    state[rng.random((t, c)) < 0.2] = np.nan
    cells = np.flatnonzero(rng.random(c) < frac).astype(np.int32)
    m = cells.size
    pos = np.full(c, -1, np.int32)
    pos[cells] = np.arange(m, dtype=np.int32)
    upd = rng.normal(20.0, 12.0, size=(t, m)).astype(np.float32)
    upd[rng.random((t, m)) < 0.1] = np.nan
    state, upd = _t(state).cuda(), _t(upd).cuda()
    cells, pos = _t(cells).cuda(), _t(pos).cuda()
    before = grid_update.launches
    got = ops.grid_scatter_(state.clone(), upd, cells, op=op)
    assert grid_update.launches == before + (m > 0)
    assert _bits_equal(got, ref.grid_scatter_(state.clone(), upd, cells,
                                              op=op))
    assert _bits_equal(got, ref.grid_update(state, upd, pos, op=op))
    keep = (pos < 0).cpu()
    assert torch.equal(got.cpu()[:, keep].view(torch.int32),
                       state.cpu()[:, keep].view(torch.int32))
    again = ops.grid_scatter_(state.clone(), upd, cells, op=op)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
def test_grid_scatter_kernel_patches_in_place_and_checks_its_inputs():
    _need_cuda()
    state = torch.zeros(2, 10, device="cuda")
    upd = torch.ones(2, 3, device="cuda")
    cells = torch.tensor([1, 4, 9], dtype=torch.int32, device="cuda")
    out = ops.grid_scatter_(state, upd, cells, op="add")
    assert out is state
    assert state.sum().item() == 6.0 and state[:, [1, 4, 9]].eq(1).all()
    with pytest.raises(TypeError, match="float32"):
        ops.grid_scatter_(state.double(), upd, cells)
    with pytest.raises(ValueError, match="contiguous"):
        ops.grid_scatter_(state.t(), upd, cells)
    with pytest.raises(ValueError, match="unknown grid_update op"):
        ops.grid_scatter_(state, upd, cells, op="mul")


@pytest.mark.cuda
def test_incremental_qpe_fold_on_card_equals_cpu_fold_bitwise():
    _need_cuda()
    from repro_torch.radar import incremental

    rng = np.random.default_rng(12)
    dbz = rng.normal(8.0, 15.0, size=(9, 180, 301)).astype(np.float32)
    dbz[4] = -10.0                     # a dry scan
    dbz[rng.random(dbz.shape) < 0.1] = np.nan
    rates = incremental._zr_rate_rows(dbz, a=200.0, b=1.6)
    dt = incremental._rect_dt(1305849600.0 + 270.0 * np.arange(9), None)
    start = np.abs(rng.normal(size=180 * 301)).astype(np.float32)
    before = grid_update.launches
    card, n_card = incremental._fold_terms(start, rates, dt, sparse=True,
                                           device="cuda")
    assert grid_update.launches == before + 8        # one per wet scan
    host, n_host = incremental._fold_terms(start, rates, dt, sparse=True,
                                           device="cpu")
    dense, _ = incremental._fold_terms(start, rates, dt)
    assert card.tobytes() == host.tobytes() == dense.tobytes()
    assert n_card == n_host


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(64, 720, 1192), (5, 7, 11), (3, 1, 5),
                                   (9, 33, 257), (1, 2, 2)])
def test_zr_accum_kernel_on_misaligned_and_tail_shapes(shape, offset):
    _need_cuda()
    rng = np.random.default_rng(sum(shape) + offset)
    host = _radar_field(rng, *shape)
    host.reshape(-1)[:3] = [np.inf, -np.inf, 53.0]
    n = host.size
    buf = torch.empty(n + offset, device="cuda")
    buf[offset:] = _t(host.reshape(-1)).cuda()
    dbz = buf[offset:].view(shape)        # base off 16 bytes unless 0
    dt_s = _t(rng.uniform(200.0, 400.0, size=shape[:1]).astype(
        np.float32)).cuda()
    got = ops.zr_accum(dbz, dt_s)
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.zr_accum(dbz, dt_s).cpu(), **QPE_TOL)
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.zr_accum_exp2(dbz, dt_s).cpu(), **QPE_TOL)
    again = ops.zr_accum(dbz, dt_s)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, hq, hkv, sq, extra, d, causal", [
    (1, 4, 2, 1, 0, 16, True), (2, 4, 1, 130, 140, 32, True),
    (1, 2, 2, 65, 0, 128, False), (2, 12, 4, 1, 1055, 64, True),
    (1, 12, 4, 200, 0, 64, True), (1, 8, 8, 3, 61, 16, False)])
def test_flash_attention_kernel_matches_plain_on_card(b, hq, hkv, sq, extra,
                                                      d, causal, dtype):
    _need_cuda()
    rng = np.random.default_rng(sq + extra + d)
    skv = sq + extra
    dt = getattr(torch, dtype)
    q = _t(rng.normal(size=(b, hq, sq, d)).astype(np.float32)).cuda().to(dt)
    # keys and values as the prefix of a longer cache, read in place
    cache = _t(rng.normal(size=(2, b, hkv, skv + 37, d)).astype(np.float32))
    k, v = (c[:, :, :skv] for c in cache.cuda().to(dt))
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    tol = 2e-4 if dtype == "float32" else 5e-2    # tests/test_kernels.py
    want = ref.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    again = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(got, again)
    # a head dim above the widest kernel's (256) raises
    wide = torch.zeros((1, 2, 3, 264), dtype=dt, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(wide, wide, wide)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())


# bfloat16 output rows against the plain version's, each relative to its
# own L2 norm: the elementwise 5e-2 is as large as a late row's outputs,
# while one bf16 rounding of o and of P leaves a few 1e-3 a row
BF16_ROW_RTOL = 2e-2


def _assert_bf16_rows(got, want):
    g, w = got.float(), want.float()
    rows = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp(min=1e-30)
    assert float(rows.max()) <= BF16_ROW_RTOL, float(rows.max())


def _route_call(q, k, v, causal=True):
    """One kernel call, with the launch counters it must move."""
    which = flash_attention.route(q)
    before = dict(flash_attention.route_launches)
    n = flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == n + 1
    before[which] += 1
    assert flash_attention.route_launches == before
    return got, which


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("skv", [1, 63, 64, 65, 1055, 2048])
def test_flash_decode_kernel_on_a_strided_cache_prefix(skv, group, dtype):
    _need_cuda()
    rng = np.random.default_rng(skv + group)
    dt = getattr(torch, dtype)
    b, hkv, d = 3, 2, 64
    q = _t(rng.normal(size=(b, hkv * group, 1, d)).astype(np.float32))
    cache = _t(rng.normal(size=(2, b, hkv, 2100, d)).astype(np.float32))
    q = q.cuda().to(dt)
    k, v = (c[:, :, :skv] for c in cache.cuda().to(dt))
    got, which = _route_call(q, k, v)
    assert which == "decode" and got.dtype == dt and got.shape == q.shape
    tol = 2e-4 if dtype == "float32" else 5e-2    # tests/test_kernels.py
    for want in (ref.flash_attention(q, k, v, causal=True),
                 ref.flash_decode(q, k, v, flash_attention.decode_splits(
                     b * hkv, skv, torch.cuda.get_device_properties(
                         0).multi_processor_count))):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=tol,
                                   atol=tol)
        if dt == torch.bfloat16:
            _assert_bf16_rows(got, want)
    again = ops.flash_attention(q, k, v)
    assert torch.equal(got.view(torch.int16 if dt == torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if dt == torch.bfloat16
                                  else torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [48, 80, 96, 112])
@pytest.mark.parametrize("group, skv", [(1, 1), (4, 65), (2, 1056),
                                        (8, 2048)])
def test_flash_decode_kernel_at_head_dims_off_powers_of_two(group, skv, d,
                                                            dtype):
    # a lane group of D * size / 16 lanes rounded up to a power of two: at
    # D = 80, 10 of 16 lanes in bf16 and 20 of 32 in float32 read the row
    _need_cuda()
    rng = np.random.default_rng(skv + group + d)
    dt = getattr(torch, dtype)
    b, hkv = 2, 2
    q = _t(rng.normal(size=(b, hkv * group, 1, d)).astype(np.float32))
    cache = _t(rng.normal(size=(2, b, hkv, skv + 40, d)).astype(np.float32))
    q = q.cuda().to(dt)
    k, v = (c[:, :, :skv] for c in cache.cuda().to(dt))
    got, which = _route_call(q, k, v)
    assert which == "decode" and got.dtype == dt and got.shape == q.shape
    tol = 2e-4 if dtype == "float32" else 5e-2    # tests/test_kernels.py
    splits = flash_attention.decode_splits(
        b * hkv, skv, torch.cuda.get_device_properties(0).multi_processor_count)
    for want in (ref.flash_attention(q, k, v, causal=True),
                 ref.flash_decode(q, k, v, splits)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=tol,
                                   atol=tol)
        if dt == torch.bfloat16:
            _assert_bf16_rows(got, want)
    again = ops.flash_attention(q, k, v)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [257, 264, 320, 512])
def test_flash_attention_refuses_head_dims_off_its_set(d):
    # no quiet plain path: a head dim no kernel takes (above 256, the
    # widest kernel's) raises on every route
    _need_cuda()
    for dt in (torch.float32, torch.bfloat16):
        for sq in (1, 70):
            q = torch.zeros((1, 2, sq, d), dtype=dt, device="cuda")
            k = torch.zeros((1, 2, 80, d), dtype=dt, device="cuda")
            with pytest.raises(ValueError, match="head dim"):
                ops.flash_attention(q, k, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [40, 72, 136, 200, 256, 8, 33, 144, 176, 250])
@pytest.mark.parametrize("b, hq, hkv, sq, extra, causal", [
    (2, 4, 2, 100, 37, True), (1, 3, 1, 65, 0, False), (1, 2, 2, 1, 130, True),
    (2, 8, 2, 1, 1055, True)])
def test_flash_attention_routes_at_any_head_dim(b, hq, hkv, sq, extra, causal,
                                                d, dtype):
    # every D up to 256 on a kernel: zero columns up to the kernel's width
    # (a padded copy where a row is off 16-byte units), two column groups
    # of v above 128; k and v a prefix of a longer cache
    _need_cuda()
    rng = np.random.default_rng(sq + extra + d)
    dt = getattr(torch, dtype)
    skv = sq + extra
    q = _t(rng.normal(size=(b, hq, sq, d)).astype(np.float32)).cuda().to(dt)
    cache = _t(rng.normal(size=(2, b, hkv, skv + 29, d)).astype(np.float32))
    k, v = (c[:, :, :skv] for c in cache.cuda().to(dt))
    got, which = _route_call(q, k, v, causal)
    assert which == flash_attention.route(q) and got.shape == q.shape
    assert got.dtype == dt and got.is_contiguous()
    want = ref.flash_attention(q, k, v, causal=causal)
    if dt == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **F32_TOL)
        if sq > 1:
            pairs = ref.flash_attention_pairs(q, k, v, causal=causal)
            np.testing.assert_allclose(got.cpu().numpy(),
                                       pairs.cpu().numpy(), **F32_TOL)
    else:
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=5e-2,
                                   atol=5e-2)
        _assert_bf16_rows(got, want)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 48, 80, 96, 112])
@pytest.mark.parametrize("sq, skv, causal", [
    (100, 100, True), (130, 270, True), (65, 1100, True), (2, 2, True),
    (200, 200, False), (77, 3, False)])
def test_tc_prefill_kernel_bf16(sq, skv, causal, d):
    _need_cuda()
    rng = np.random.default_rng(sq + skv + d)
    b, hq, hkv = 2, 6, 2
    q = _t(rng.normal(size=(b, hq, sq, d)).astype(np.float32))
    q = q.cuda().to(torch.bfloat16)
    cache = _t(rng.normal(size=(2, b, hkv, skv + 64, d)).astype(np.float32))
    k, v = (c[:, :, :skv] for c in cache.cuda().to(torch.bfloat16))
    got, which = _route_call(q, k, v, causal)
    assert which == "tc_prefill" and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=5e-2,
                               atol=5e-2)
    _assert_bf16_rows(got, want)
    again = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_routes_read_transposed_views(dtype):
    # the model's forward without a cache hands (B, S, H, D) tensors
    # transposed to (B, H, S, D)
    _need_cuda()
    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)
    b, s, hq, hkv, d = 2, 150, 8, 4, 64

    def view(h, n):
        x = _t(rng.normal(size=(b, n, h, d)).astype(np.float32))
        return x.cuda().to(dt).transpose(1, 2)

    q, k, v = view(hq, s), view(hkv, s), view(hkv, s)
    got, which = _route_call(q, k, v)
    assert which == ("tc_prefill" if dtype == "bfloat16" else "f32")
    tol = 2e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        ref.flash_attention(q, k, v).float().cpu().numpy(), rtol=tol,
        atol=tol)
    q1 = view(hq, 1)
    got, which = _route_call(q1, k, v)
    assert which == "decode"
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        ref.flash_attention(q1, k, v).float().cpu().numpy(), rtol=tol,
        atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 70])
def test_flash_attention_takes_views_off_16_byte_units(sq):
    # q starts one element into its buffer and k's rows sit 68 values
    # apart: the vector and TMA loads need 16-byte units, so the wrapper
    # copies such views rather than read them misaligned
    _need_cuda()
    rng = np.random.default_rng(sq)
    b, hq, hkv, skv, d = 2, 4, 2, 90, 64
    flat = _t(rng.normal(size=(b * hq * sq * d + 1,)).astype(np.float32))
    q = flat.cuda().to(torch.bfloat16)[1:].view(b, hq, sq, d)
    wide = _t(rng.normal(size=(2, b, hkv, skv, d + 4)).astype(np.float32))
    k, v = (x[..., :d] for x in wide.cuda().to(torch.bfloat16))
    got, which = _route_call(q, k, v)
    assert which == ("decode" if sq == 1 else "tc_prefill")
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        ref.flash_attention(q, k, v).float().cpu().numpy(), rtol=5e-2,
        atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, l, h, p, n, with_h0", [
    (1, 1, 2, 16, 16, True), (2, 64, 2, 16, 16, False),
    (1, 65, 1, 8, 16, True), (2, 130, 4, 16, 8, True),
    (2, 1000, 3, 64, 64, True), (1, 100, 2, 72, 80, False)])
def test_mamba2_scan_kernel_matches_plain_on_card(b, l, h, p, n, with_h0,
                                                  dtype):
    _need_cuda()
    rng = np.random.default_rng(l + h + p + n)
    dt_ = getattr(torch, dtype)
    # x, B and C as views of one wider last axis, as the conv output split
    wide = _t(rng.normal(size=(b, l, h * p + 2 * n)).astype(np.float32))
    wide = wide.cuda().to(dt_)
    x = wide[..., :h * p].reshape(b, l, h, p)
    Bm, Cm = wide[..., h * p:h * p + n], wide[..., h * p + n:]
    dt = _t(rng.uniform(0.001, 0.1, size=(b, l, h)).astype(np.float32)).cuda()
    A = _t(-rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)).cuda()
    h0 = (_t(rng.normal(size=(b, h, p, n)).astype(np.float32)).cuda()
          if with_h0 else None)
    before = mamba2_scan.launches
    y, hN = ops.mamba2_scan(x, dt, A, Bm, Cm, h0=h0)
    assert mamba2_scan.launches == before + 1
    assert y.dtype == dt_ and y.shape == x.shape
    assert hN.dtype == torch.float32 and hN.shape == (b, h, p, n)
    y_ref, h_ref = ref.mamba2_scan(x, dt, A, Bm, Cm, h0=h0)
    # float32: tests/test_kernels.py:330-331; bf16: both versions round y
    # once to bf16 from float32 sums that differ only in order, so they
    # differ by at most one bf16 step, 2**-7 of |y|
    tol = 2e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_ref.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(hN.cpu().numpy(), h_ref.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    again = ops.mamba2_scan(x, dt, A, Bm, Cm, h0=h0)
    assert torch.equal(y, again[0]) and torch.equal(hN, again[1])
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        ops.mamba2_scan(x.half(), dt, A, Bm.half(), Cm.half())
    # P is tiled over the grid; N above the tile bound (365) raises
    wide_state = [torch.zeros(shape, device="cuda")
                  for shape in ((1, 2, 1, 512), (1, 2, 1), (1,), (1, 2, 400))]
    with pytest.raises(ValueError, match="shared memory"):
        ops.mamba2_scan(*wide_state, wide_state[-1])


def _scan_inputs(rng, b, l, h, p, n, dt_, with_h0, offset=0):
    # x, B and C as views of one wider last axis (the conv output split),
    # starting `offset` elements into their buffer
    wide = _t(rng.normal(size=(b * l * (h * p + 2 * n) + offset,)).astype(
        np.float32)).cuda().to(dt_)[offset:].view(b, l, h * p + 2 * n)
    x = wide[..., :h * p].reshape(b, l, h, p)
    Bm, Cm = wide[..., h * p:h * p + n], wide[..., h * p + n:]
    dt = _t(rng.uniform(0.001, 0.1, size=(b, l, h)).astype(np.float32)).cuda()
    A = _t(-rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)).cuda()
    h0 = (_t(rng.normal(size=(b, h, p, n)).astype(np.float32)).cuda()
          if with_h0 else None)
    return x, dt, A, Bm, Cm, h0


def _scan_route_call(x, dt, A, Bm, Cm, h0):
    which = mamba2_scan.route(x, Bm.shape[-1])
    before = dict(mamba2_scan.route_launches)
    y, hN = ops.mamba2_scan(x, dt, A, Bm, Cm, h0=h0)
    before[which] += 1
    assert mamba2_scan.route_launches == before
    return y, hN, which


def _assert_scan_close(y, hN, want_y, want_h):
    # y: 2e-4 in float32 (tests/test_kernels.py:330-331), 1e-2 in bf16 (one
    # bf16 rounding of y in each version); the float32 state at 2e-4
    tol = 2e-4 if y.dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want_y.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(hN.cpu().numpy(), want_h.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, l, p, n, with_h0, expect", [
    ("float32", 130, 16, 16, True, "f32"),
    ("bfloat16", 1024, 64, 64, True, "chunk_tc"),
    ("bfloat16", 1024, 64, 64, False, "chunk_tc"),
    ("bfloat16", 63, 16, 16, True, "chunk_tc"),
    ("bfloat16", 65, 8, 16, True, "chunk_tc"),
    ("bfloat16", 300, 16, 8, False, "chunk_tc"),
    ("bfloat16", 2, 72, 80, True, "chunk_tc"),
    ("bfloat16", 129, 128, 128, True, "chunk_tc"),
    ("bfloat16", 70, 9, 12, True, "chunk_tc"),
    ("float32", 1, 64, 64, True, "decode"),
    ("bfloat16", 1, 64, 64, True, "decode"),
    ("bfloat16", 1, 72, 80, False, "decode"),
    ("float32", 1, 8, 6, True, "decode"),
    ("bfloat16", 130, 64, 192, True, "bf16_wide"),
    ("bfloat16", 70, 136, 16, False, "bf16_wide"),
    ("bfloat16", 2, 8, 160, False, "bf16_wide"),
    ("float32", 1, 4, 300, True, "f32_wide"),
    ("bfloat16", 1, 4, 300, True, "bf16_wide")])
def test_mamba2_scan_routes_on_card(dtype, l, p, n, with_h0, expect):
    _need_cuda()
    rng = np.random.default_rng(l + p + n)
    args = _scan_inputs(rng, 2, l, 3, p, n, getattr(torch, dtype), with_h0)
    y, hN, which = _scan_route_call(*args)
    assert which == expect
    assert y.dtype == args[0].dtype and y.shape == args[0].shape
    x, dt, A, Bm, Cm, h0 = args
    _assert_scan_close(y, hN, *ref.mamba2_scan(x, dt, A, Bm, Cm, h0=h0))
    if which == "chunk_tc":
        _assert_scan_close(y, hN, *ref.mamba2_scan_chunks(x, dt, A, Bm, Cm,
                                                          h0=h0))
    again = ops.mamba2_scan(x, dt, A, Bm, Cm, h0=h0)
    assert torch.equal(y, again[0]) and torch.equal(hN, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_mamba2_chunk_tc_takes_strided_and_misaligned_views(offset):
    # x, B and C are views with a row stride of H P + 2 N; with offset 1
    # they start one element into their buffer, off the 16-byte units TMA
    # needs, so the wrapper copies them
    _need_cuda()
    rng = np.random.default_rng(40 + offset)
    x, dt, A, Bm, Cm, h0 = _scan_inputs(rng, 2, 200, 4, 64, 64,
                                        torch.bfloat16, True, offset)
    assert not x.is_contiguous()
    y, hN, which = _scan_route_call(x, dt, A, Bm, Cm, h0)
    assert which == "chunk_tc"
    _assert_scan_close(y, hN, *ref.mamba2_scan(x, dt, A, Bm, Cm, h0=h0))
    # dt read through its strides too: a transposed view
    dt_t = dt.transpose(0, 1).contiguous().transpose(0, 1)
    y2, h2, _ = _scan_route_call(x, dt_t, A, Bm, Cm, h0)
    assert torch.equal(y, y2) and torch.equal(hN, h2)


@pytest.mark.cuda
def test_mamba2_scan_routes_name_their_width_limits():
    # wider than the tensor-core and decode kernels go to the wide kernel;
    # it tiles P over the grid, so the one limit left is N, whose B and C
    # chunks fill a block's shared memory beside a tile of 16 columns
    _need_cuda()
    rng = np.random.default_rng(9)
    args = _scan_inputs(rng, 1, 3, 1, 136, 16, torch.bfloat16, False)
    assert mamba2_scan.route(args[0], 16) == "bf16_wide"
    args = _scan_inputs(rng, 1, 1, 1, 4, 300, torch.float32, False)
    assert mamba2_scan.route(args[0], 300) == "f32_wide"
    assert mamba2_scan.WIDE_MAX_N == 365
    for dtype in (torch.float32, torch.bfloat16):
        for p, n in ((256, 400), (16, mamba2_scan.WIDE_MAX_N + 1)):
            args = _scan_inputs(rng, 1, 3, 1, p, n, dtype, False)
            with pytest.raises(ValueError, match="bytes of shared memory"):
                ops.mamba2_scan(*args[:5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l, p, n, with_h0", [
    (130, 160, 160, True), (70, 256, 192, False), (2, 256, 192, True),
    (1, 40, 365, True), (65, 33, 365, False)])
def test_wide_scan_tiles_p_over_the_grid(l, p, n, with_h0, dtype):
    # a state wider than a block's shared memory: tiles of P's columns,
    # each the whole's values (every tile computes the same M in the same
    # order), so the tiled scan equals the scan of each P slice
    _need_cuda()
    rng = np.random.default_rng(70 + l + p + n)
    dt_ = getattr(torch, dtype)
    x, dt, A, Bm, Cm, h0 = _scan_inputs(rng, 2, l, 3, p, n, dt_, with_h0)
    assert mamba2_scan.wide_p_tile(p, n) < p
    y, hN, which = _scan_route_call(x, dt, A, Bm, Cm, h0)
    assert which == ("f32_wide" if dtype == "float32" else "bf16_wide")
    _assert_scan_close(y, hN, *ref.mamba2_scan(x, dt, A, Bm, Cm, h0=h0))
    # one P slice through the kernel: its tile's values, bitwise
    cut = slice(p - 16, p)
    ys, hs = ops.mamba2_scan(x[..., cut], dt, A, Bm, Cm,
                             h0=None if h0 is None else h0[:, :, cut])
    assert torch.equal(ys, y[..., cut]) and torch.equal(hs, hN[:, :, cut])


# ---------------------------------------------------------------------------
# the float32 routes: tensor cores, every float32 operand as a bf16 pair
# ---------------------------------------------------------------------------

F32_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py, float32


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 48, 80, 96, 112])
@pytest.mark.parametrize("b, hq, hkv, sq, extra, causal", [
    (2, 4, 2, 100, 0, True), (1, 6, 2, 130, 140, True), (2, 2, 2, 65, 0, False),
    (1, 8, 8, 3, 61, False), (1, 4, 1, 2, 2, True), (2, 4, 4, 200, 37, True)])
def test_f32_prefill_kernel_matches_its_plain_versions(b, hq, hkv, sq, extra,
                                                       causal, d):
    _need_cuda()
    rng = np.random.default_rng(sq + extra + d)
    skv = sq + extra
    q = _t(rng.normal(size=(b, hq, sq, d)).astype(np.float32)).cuda()
    # keys and values as the prefix of a longer cache, read in place
    cache = _t(rng.normal(size=(2, b, hkv, skv + 29, d)).astype(np.float32))
    k, v = (c[:, :, :skv] for c in cache.cuda())
    got, which = _route_call(q, k, v, causal)
    assert which == "f32" and got.dtype == torch.float32
    assert got.shape == q.shape
    for want in (ref.flash_attention(q, k, v, causal=causal),
                 ref.flash_attention_pairs(q, k, v, causal=causal)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **F32_TOL)
    again = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("offset, pad", [(1, 0), (0, 2), (3, 1)])
def test_f32_prefill_takes_views_off_16_byte_units(offset, pad):
    # q starts `offset` floats into its buffer and k's and v's rows sit
    # d + pad values apart: the TMA copies need 16-byte units, so the
    # wrapper copies such views rather than read them misaligned
    _need_cuda()
    rng = np.random.default_rng(offset + 10 * pad)
    b, hq, hkv, sq, skv, d = 2, 4, 2, 70, 90, 64
    flat = _t(rng.normal(size=(b * hq * sq * d + offset,)).astype(np.float32))
    q = flat.cuda()[offset:].view(b, hq, sq, d)
    wide = _t(rng.normal(size=(2, b, hkv, skv, d + pad)).astype(np.float32))
    k, v = (x[..., :d] for x in wide.cuda())
    got, which = _route_call(q, k, v)
    assert which == "f32"
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.flash_attention(q, k, v).cpu().numpy(),
                               **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b, l, h, p, n, with_h0", [
    (2, 2, 3, 16, 16, True), (2, 63, 3, 8, 16, False), (2, 65, 3, 16, 8, True),
    (2, 300, 3, 72, 80, True), (2, 129, 2, 128, 128, True),
    (2, 70, 3, 9, 12, True), (1, 1000, 2, 64, 64, False),
    (2, 200, 4, 64, 64, True), (1, 130, 2, 136, 33, False)])
def test_f32_scan_kernel_matches_its_plain_versions(b, l, h, p, n, with_h0):
    _need_cuda()
    rng = np.random.default_rng(l + p + n)
    args = _scan_inputs(rng, b, l, h, p, n, torch.float32, with_h0)
    y, hN, which = _scan_route_call(*args)
    assert which == "f32"
    assert y.dtype == torch.float32 and y.shape == args[0].shape
    x, dt, A, Bm, Cm, h0 = args
    _assert_scan_close(y, hN, *ref.mamba2_scan(x, dt, A, Bm, Cm, h0=h0))
    _assert_scan_close(y, hN, *ref.mamba2_scan_chunks(x, dt, A, Bm, Cm,
                                                      h0=h0))
    again = ops.mamba2_scan(x, dt, A, Bm, Cm, h0=h0)
    assert torch.equal(y, again[0]) and torch.equal(hN, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_f32_scan_takes_strided_and_misaligned_views(offset):
    # x, B and C are views with a row stride of H P + 2 N; with offset 1
    # they start one float into their buffer, off the 16-byte units TMA
    # needs, so the wrapper copies them
    _need_cuda()
    rng = np.random.default_rng(50 + offset)
    x, dt, A, Bm, Cm, h0 = _scan_inputs(rng, 2, 200, 4, 64, 64,
                                        torch.float32, True, offset)
    assert not x.is_contiguous()
    y, hN, which = _scan_route_call(x, dt, A, Bm, Cm, h0)
    assert which == "f32"
    _assert_scan_close(y, hN, *ref.mamba2_scan(x, dt, A, Bm, Cm, h0=h0))
    dt_t = dt.transpose(0, 1).contiguous().transpose(0, 1)
    y2, h2, _ = _scan_route_call(x, dt_t, A, Bm, Cm, h0)
    assert torch.equal(y, y2) and torch.equal(hN, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("l, with_h0", [(2, True), (130, False)])
def test_f32_scan_wider_than_the_tensor_cores_takes_the_cuda_cores(l,
                                                                   with_h0):
    _need_cuda()
    rng = np.random.default_rng(60 + l)
    x, dt, A, Bm, Cm, h0 = _scan_inputs(rng, 2, l, 3, 16, 160,
                                        torch.float32, with_h0)
    before = dict(mamba2_scan.route_launches)
    y, hN = ops.mamba2_scan(x, dt, A, Bm, Cm, h0=h0)
    before["f32_wide"] += 1
    assert mamba2_scan.route_launches == before
    _assert_scan_close(y, hN, *ref.mamba2_scan(x, dt, A, Bm, Cm, h0=h0))
