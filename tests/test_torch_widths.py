"""Head dims of any width, decode groups over 8, scans of any P and N, on
the CPU.

The attention kernels take every head dim: up to 256 a kernel of width
``kernel_dim(D)`` reads the caller's D columns with zeros past them,
scales by the true D and stores D columns; above it S is summed over
k-slices and v and o split into column groups (``wide_tiling``,
``decode_tiling``), and a decode group wider than 8 heads is sliced over
the grid.  The scan's wide kernel tiles P over the grid and passes B and
C in slices of N.  All rest on identities the CPU can check: here the
port's plain attention at D = 40, 72, 136, 200, 256, 320 and 512 and at
a group of 16 is held against the reference's oracle and its Pallas
kernel in interpret mode,
the zero-pad identity (padded inputs, true-D scale, sliced output)
against the unpadded plain version, the plain scan at P = N = 160 and at
N = 384 and 512 against the reference's Pallas kernel in interpret mode,
and the scan of P's slices, concatenated, against the whole.  The CUDA kernels at these
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
    assert flash_attention.SLICED_ABOVE == 256 == dims[-1]
    for d in range(1, 257):
        w = flash_attention.kernel_dim(d)
        assert w in dims and w >= d
        # the narrowest width that holds d: 16s up to 128, then 32s
        assert w - d < (16 if d <= 128 else 32)
    # above 256 no kernel width bounds D: the wide prefill sums S over
    # k-slices of 64 columns, each of its two warpgroups holds up to four
    # 64-column chunks of o, so a block covers all of D up to 512 and
    # computes S once for them; column blocks over the grid cover a wider
    # D, each computing S again.  The decode kernel walks a key row in
    # passes of 256 columns, a block owning 256 of v and o
    for d in (257, 264, 288, 320, 384, 512, 1000, 4096):
        for dtype in (torch.bfloat16, torch.float32):
            assert flash_attention.wide_smem_bytes(d, dtype) \
                <= mamba2_scan.SMEM_LIMIT, (d, dtype)
        slices, per_block, blocks = flash_attention.wide_tiling(d)
        assert slices == -(-d // flash_attention.WIDE_SLICE)
        chunks = per_block // (flash_attention.WIDE_GROUPS
                               * flash_attention.WIDE_SLICE)
        assert per_block == (flash_attention.WIDE_GROUPS * chunks
                             * flash_attention.WIDE_SLICE)
        assert 1 <= chunks <= flash_attention.WIDE_MAX_CHUNKS
        # the column groups of the blocks span D, the last one reaching
        # into it, and S is computed once a column block
        assert (blocks - 1) * per_block < d <= blocks * per_block
        assert blocks <= -(-d // per_block)
        assert blocks == 1 if d <= 512 else per_block == 512
        passes, cgroups, gslices = flash_attention.decode_tiling(d, 16)
        assert passes == cgroups == -(-d // 256) and gslices == 2
        with pytest.raises(ValueError, match="head dim"):
            flash_attention.kernel_dim(d)
    # a group wider than 8 query heads: slices of 8 heads over the grid
    assert flash_attention.decode_tiling(64, 8) == (1, 1, 1)
    assert flash_attention.decode_tiling(256, 9) == (1, 1, 2)
    assert flash_attention.decode_tiling(512, 40) == (2, 2, 5)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.kernel_dim(0)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_p_tile_fits_the_block_and_bounds_n(dtype):
    # any N: B and C pass through shared memory in slices of 64 columns,
    # P in tiles of at most 64 columns over the grid, and the state's
    # slices leave shared memory (for the output state in global memory)
    # only where they do not all fit beside the rings
    limit = mamba2_scan.SMEM_LIMIT
    for p, n in ((160, 160), (256, 192), (64, 64), (512, 300), (4, 365),
                 (64, 384), (160, 512), (40, 3000), (16, 4096), (40, 365)):
        tile, resident = mamba2_scan.wide_tiling(p, n, dtype)
        assert 1 <= tile <= min(p, 128) and tile == min(p, 64)
        assert mamba2_scan.smem_bytes(n, dtype, resident) <= limit
        assert resident == (mamba2_scan.smem_bytes(n, dtype) <= limit)
    assert mamba2_scan.wide_p_tile(160, 160) == 64
    assert mamba2_scan.wide_tiling(40, 3000, dtype) == (40, False)
    assert mamba2_scan.wide_tiling(16, 4096, dtype) == (16, False)
    # the state of zamba2-like widths stays in shared memory
    assert mamba2_scan.wide_tiling(160, 160, dtype) == (64, True)
    assert [mamba2_scan.n_slices(n) for n in (64, 365, 384, 512)] == [
        1, 6, 6, 8]
    # without the resident state the bytes do not depend on N
    assert len({mamba2_scan.smem_bytes(n, dtype, False)
                for n in (1, 365, 366, 4096, 10 ** 5)}) == 1
    assert not hasattr(mamba2_scan, "WIDE_MAX_N")


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
    assert 0 < tile <= p
    if tile == p:
        # P = 40 is one tile of the kernel; the identity is checked on 16
        # columns
        tile = 16
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


# ---------------------------------------------------------------------------
# above the old limits: D > 256, groups > 8, N > 365
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("b, hkv, group, sq, extra, causal", [
    (1, 2, 2, 70, 9, True), (1, 1, 3, 65, 0, False), (2, 1, 16, 1, 90, True)])
def test_plain_attention_above_256(b, hkv, group, sq, extra, causal, d):
    q, k, v = _qkv(sq + extra + d, b, hkv * group, hkv, sq, sq + extra, d)
    want = np.asarray(jax_ref.flash_attention(q, k, v, causal=causal))
    pallas = np.asarray(flash_attention_pallas(q, k, v, causal=causal,
                                               bq=64, bk=64, interpret=True))
    outs = [ref.flash_attention(_t(q), _t(k), _t(v), causal=causal),
            ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)]
    if sq == 1:
        outs.append(ref.flash_decode(_t(q), _t(k), _t(v), 3))
    else:
        outs.append(ref.flash_attention_pairs(_t(q), _t(k), _t(v),
                                              causal=causal))
    for out in outs:
        assert out.shape == q.shape
        np.testing.assert_allclose(out.numpy(), want, **F32_TOL)
        np.testing.assert_allclose(out.numpy(), pallas, **F32_TOL)


@pytest.mark.parametrize("d", [64, 320])
def test_plain_decode_at_group_16_and_bf16_above_256(d):
    q, k, v = _qkv(d, 2, 32, 2, 1, 300, d)
    want = np.asarray(jax_ref.flash_attention(q, k, v, causal=True))
    for n_split in (1, 4):
        got = ref.flash_decode(_t(q), _t(k), _t(v), n_split)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jax_ref.flash_attention(jq, jk, jv, causal=True),
                   np.float32), **BF16_TOL)


@pytest.mark.parametrize("n", [384, 512])
@pytest.mark.parametrize("l, p, with_h0", [(70, 16, False), (1, 8, True)])
def test_plain_scan_above_365_matches_the_reference(l, p, n, with_h0):
    x, dt, A, Bm, Cm, h0 = _scan_inputs(l + p + n, 1, l, 2, p, n, with_h0)
    tx = _t(x)
    assert mamba2_scan.route(tx, n) == "f32_wide"
    y, hN = ops.mamba2_scan(tx, _t(dt), _t(A), _t(Bm), _t(Cm),
                            h0=None if h0 is None else _t(h0))
    wants = [jax_ref.mamba2_scan(x, dt, A, Bm, Cm, h0=h0)]
    if h0 is None:
        wants.append(mamba2_scan_pallas(x, dt, A, Bm, Cm, cs=64,
                                        interpret=True))
    for yw, hw in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), **F32_TOL)
        np.testing.assert_allclose(hN.numpy(), np.asarray(hw), **F32_TOL)


# ---------------------------------------------------------------------------
# the wide scan's roundings: the chunked form at P or N above 128
# ---------------------------------------------------------------------------

SSM_BF16_Y_TOL = dict(rtol=1e-2, atol=1e-2)   # chip_smoke.py, bf16 y
WIDE_SCANS = [(160, 160), (256, 192), (64, 384), (40, 365)]


def _wide_chunks(inp, dtype, terms=3, parts=2):
    """``ref.mamba2_scan_chunks`` (chunks of 64, the wide kernel's
    roundings: ``parts=3`` in float32) on x, B and C in ``dtype``; also the
    float32 values the reference is given (bf16 inputs are exact in
    float32)."""
    x, dt, A, Bm, Cm, h0 = inp
    tx, tB, tC = (_t(a).to(dtype) for a in (x, Bm, Cm))
    y, hN = ref.mamba2_scan_chunks(tx, _t(dt), _t(A), tB, tC,
                                   h0=None if h0 is None else _t(h0),
                                   chunk=64, terms=terms, parts=parts)
    vals = [a.float().numpy() for a in (tx, tB, tC)]
    return y, hN, (vals[0], dt, A, vals[1], vals[2], h0)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtype, parts", [(torch.bfloat16, 2),
                                          (torch.float32, 2),
                                          (torch.float32, 3)])
@pytest.mark.parametrize("p, n", WIDE_SCANS)
def test_chunked_scan_at_wide_widths_matches_reference_and_pallas(
        p, n, dtype, parts, with_h0):
    # the plain versions of the tensor-core roundings at the wide widths
    # (pairs; bf16_wide's), and f32_wide's three-part form: y at 2e-4 in
    # float32 (tests/test_kernels.py:330-331) and at 1e-2 in bf16 (y
    # rounded once to bf16), the float32 state at 2e-4 in both, against
    # the reference's sequential scan and its Pallas kernel in interpret
    # mode
    inp = _scan_inputs(p + n + with_h0, 1, 70, 2, p, n, with_h0)
    y, hN, vals = _wide_chunks(inp, dtype, parts=parts)
    assert y.dtype == dtype and tuple(y.shape) == (1, 70, 2, p)
    assert hN.dtype == torch.float32 and tuple(hN.shape) == (1, 2, p, n)
    ytol = F32_TOL if dtype == torch.float32 else SSM_BF16_Y_TOL
    wants = [jax_ref.mamba2_scan(*vals[:5], h0=vals[5])]
    if not with_h0:
        wants.append(mamba2_scan_pallas(*vals[:5], cs=64, interpret=True))
    for want_y, want_h in wants:
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y),
                                   **ytol)
        np.testing.assert_allclose(hN.numpy(), np.asarray(want_h),
                                   **F32_TOL)


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("p, n", WIDE_SCANS)
def test_chunked_scan_at_wide_widths_one_term_fails_the_tolerance(p, n,
                                                                  parts):
    # hi.hi alone must miss the float32 tolerance, so it sees what the
    # other parts add
    inp = _scan_inputs(p + n, 1, 70, 2, p, n, True)
    y, _, vals = _wide_chunks(inp, torch.float32, terms=1, parts=parts)
    want_y, _ = jax_ref.mamba2_scan(*vals[:5], h0=vals[5])
    assert not np.allclose(y.numpy(), np.asarray(want_y), **F32_TOL)


def test_three_parts_hold_the_float32_tolerance_where_pairs_miss_it():
    # a sum of 3000 terms over N: pairs (16 bits) miss 2e-4 in y, f32_wide's
    # three parts hold it; the state sums over 64 tokens and holds either way
    inp = _scan_inputs(3000, 1, 130, 2, 16, 3000, True)
    want_y, want_h = jax_ref.mamba2_scan(*inp[:5], h0=inp[5])
    got = {parts: _wide_chunks(inp, torch.float32, parts=parts)[:2]
           for parts in (2, 3)}
    assert not np.allclose(got[2][0].numpy(), np.asarray(want_y), **F32_TOL)
    np.testing.assert_allclose(got[3][0].numpy(), np.asarray(want_y),
                               **F32_TOL)
    for parts in (2, 3):
        np.testing.assert_allclose(got[parts][1].numpy(), np.asarray(want_h),
                                   **F32_TOL)
    with pytest.raises(ValueError, match="parts"):
        ref.mamba2_scan_chunks(*(_t(a) for a in inp[:5]), parts=4)
