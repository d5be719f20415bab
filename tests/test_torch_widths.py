"""Head dims up to 256 and scans of any P, on the CPU.

The attention kernels take every head dim from 1 to 256: a kernel of
width ``kernel_dim(D)`` reads the caller's D columns with zeros past
them, scales by the true D and stores D columns.  The scan's wide kernel
tiles P over the grid.  Both rest on identities the CPU can check: here
the port's plain attention at D = 40, 72, 136, 200 and 256 is held
against the reference's oracle and its Pallas kernel in interpret mode,
the zero-pad identity (padded inputs, true-D scale, sliced output)
against the unpadded plain version, the plain scan at P = N = 160
against the reference's Pallas kernel in interpret mode, and the scan of
P's slices, concatenated, against the whole.  The CUDA kernels at these
widths are in ``tests/test_torch_kernels_cuda.py``, marked ``cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.mamba2_scan import mamba2_scan_pallas  # noqa: E402
from repro_torch.kernels import flash_attention, mamba2_scan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py:281
BF16_TOL = dict(rtol=5e-2, atol=5e-2)  # tests/test_kernels.py:291
WIDTHS = [40, 72, 136, 200, 256]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def test_kernel_dims_cover_every_head_dim_up_to_256():
    dims = flash_attention.HEAD_DIMS + flash_attention.WIDE_HEAD_DIMS
    assert flash_attention.MAX_HEAD_DIM == 256 == dims[-1]
    for d in range(1, 257):
        w = flash_attention.kernel_dim(d)
        assert w in dims and w >= d
        # the narrowest width that holds d: 16s up to 128, then 32s
        assert w - d < (16 if d <= 128 else 32)
    for bad in (0, 257, 320):
        with pytest.raises(ValueError, match="head dim"):
            flash_attention.kernel_dim(bad)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b, hkv, group, sq, extra, causal", [
    (1, 2, 2, 130, 0, True), (2, 1, 4, 1, 140, True),
    (1, 2, 1, 65, 7, False)])
def test_plain_attention_at_wide_and_odd_head_dims(b, hkv, group, sq, extra,
                                                   causal, d):
    q, k, v = _qkv(sq + extra + d, b, hkv * group, hkv, sq, sq + extra, d)
    want = np.asarray(jax_ref.flash_attention(q, k, v, causal=causal))
    pallas = np.asarray(flash_attention_pallas(q, k, v, causal=causal,
                                               bq=64, bk=64, interpret=True))
    got = ref.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    pairs = ref.flash_attention_pairs(_t(q), _t(k), _t(v), causal=causal)
    for out in (got, pairs):
        assert out.shape == q.shape and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), want, **F32_TOL)
        np.testing.assert_allclose(out.numpy(), pallas, **F32_TOL)
    if sq == 1:
        dec = ref.flash_decode(_t(q), _t(k), _t(v), 3)
        np.testing.assert_allclose(dec.numpy(), want, **F32_TOL)
    # the CPU path of the wrapper (the plain version) at the same widths
    np.testing.assert_allclose(
        ops.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy(),
        want, **F32_TOL)


@pytest.mark.parametrize("d", [40, 200])
def test_plain_attention_bf16_at_wide_head_dims(d):
    q, k, v = _qkv(d, 2, 4, 2, 70, 70, d)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = ref.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    for want in (jax_ref.flash_attention(jq, jk, jv, causal=True),
                 flash_attention_pallas(jq, jk, jv, causal=True, bq=64,
                                        bk=64, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("d", [8, 33, 40, 136, 200, 250])
@pytest.mark.parametrize("sq, skv, causal", [(70, 70, True), (1, 90, True),
                                             (33, 50, False)])
def test_zero_pad_identity(sq, skv, causal, d):
    # zero columns up to the kernel's width, the scale of the true D and
    # the output sliced back: what every route computes, against the
    # unpadded plain version, in the pair form the f32 kernel rounds by
    # and in the one-split decode form too
    q, k, v = _qkv(d + sq, 2, 4, 2, sq, skv, d)
    tq, tk, tv = _t(q), _t(k), _t(v)
    w = flash_attention.kernel_dim(d)
    pad = (0, w - d)
    pq, pk, pv = (torch.nn.functional.pad(x, pad) for x in (tq, tk, tv))
    scale = 1.0 / d ** 0.5
    for fn in (ref.flash_attention, ref.flash_attention_pairs):
        want = fn(tq, tk, tv, causal=causal)
        got = fn(pq, pk, pv, causal=causal, scale=scale)
        assert torch.all(got[..., d:] == 0)
        np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)
    if sq == 1:
        want = ref.flash_decode(tq, tk, tv, 2)
        got = ref.flash_decode(pq, pk, pv, 2, scale=scale)
        np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)


def _scan_inputs(seed, b, l, h, p, n, with_h0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, l, h)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)
    Bm = rng.normal(size=(b, l, n)).astype(np.float32)
    Cm = rng.normal(size=(b, l, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if with_h0 \
        else None
    return x, dt, A, Bm, Cm, h0


def test_wide_p_tile_fits_the_block_and_bounds_n():
    limit = mamba2_scan.SMEM_LIMIT
    for p, n in ((160, 160), (256, 192), (64, 64), (512, 300), (4, 365)):
        tile = mamba2_scan.wide_p_tile(p, n)
        assert 1 <= tile <= p and mamba2_scan.smem_bytes(tile, n) <= limit
        if mamba2_scan.smem_bytes(p, n) <= limit:
            assert tile == p      # one tile: the old kernel's launch
    assert mamba2_scan.wide_p_tile(160, 160) == 80
    n_max = mamba2_scan.WIDE_MAX_N
    assert mamba2_scan.smem_bytes(16, n_max) <= limit \
        < mamba2_scan.smem_bytes(16, n_max + 1)
    assert mamba2_scan.wide_p_tile(256, n_max + 1) == 0


def test_plain_scan_at_p_n_160_matches_the_pallas_kernel():
    x, dt, A, Bm, Cm, _ = _scan_inputs(160, 1, 130, 2, 160, 160, False)
    tx = _t(x)
    assert mamba2_scan.route(tx, 160) == "f32_wide"
    y, hN = ops.mamba2_scan(tx, _t(dt), _t(A), _t(Bm), _t(Cm))
    y_pal, h_pal = mamba2_scan_pallas(x, dt, A, Bm, Cm, cs=64,
                                      interpret=True)
    y_ref, h_ref = jax_ref.mamba2_scan(x, dt, A, Bm, Cm)
    for yw, hw in ((y_pal, h_pal), (y_ref, h_ref)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), **F32_TOL)
        np.testing.assert_allclose(hN.numpy(), np.asarray(hw), **F32_TOL)


@pytest.mark.parametrize("l, p, n, with_h0", [(130, 160, 160, True),
                                              (70, 256, 192, False),
                                              (1, 40, 365, True)])
def test_p_tiled_scan_equals_the_whole(l, p, n, with_h0):
    # state rows and output columns of different p depend on x[:, p] alone:
    # the plain scan of each tile, concatenated, is the whole scan, and the
    # tile's chunked form (the kernel's arithmetic) is too
    x, dt, A, Bm, Cm, h0 = _scan_inputs(l + p + n, 2, l, 2, p, n, with_h0)
    tx, tdt, tA, tB, tC = (_t(a) for a in (x, dt, A, Bm, Cm))
    th0 = None if h0 is None else _t(h0)
    y, hN = ref.mamba2_scan(tx, tdt, tA, tB, tC, h0=th0)
    tile = mamba2_scan.wide_p_tile(p, n)
    assert 0 < tile < p
    ys, hs = [], []
    for p0 in range(0, p, tile):
        cut = slice(p0, min(p0 + tile, p))
        yt, ht = ref.mamba2_scan(tx[..., cut], tdt, tA, tB, tC,
                                 h0=None if th0 is None else th0[:, :, cut])
        ys.append(yt)
        hs.append(ht)
    np.testing.assert_allclose(torch.cat(ys, -1).numpy(), y.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(torch.cat(hs, 2).numpy(), hN.numpy(),
                               rtol=1e-6, atol=1e-6)
    y_ref, h_ref = jax_ref.mamba2_scan(x, dt, A, Bm, Cm, h0=h0)
    np.testing.assert_allclose(torch.cat(ys, -1).numpy(), np.asarray(y_ref),
                               **F32_TOL)
    np.testing.assert_allclose(torch.cat(hs, 2).numpy(), np.asarray(h_ref),
                               **F32_TOL)
