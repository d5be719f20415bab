"""The plain versions of the port's float32 tensor-core routes against the
reference package's, on the CPU.

``flash_attention`` and ``mamba2_scan`` send a float32 prefill to their
``f32`` routes (``kernels/flash_attention.py`` and
``kernels/mamba2_scan.py``, ``route``): the tensor cores, with every
float32 operand as a bf16 pair, ``hi = bf16(v)``, ``lo = bf16(v - hi)``,
and every product as three bf16 products (hi.hi + hi.lo + lo.hi, lo.lo
dropped).  Their plain versions with the same roundings,
``ref.flash_attention_pairs`` and ``ref.mamba2_scan_chunks`` on float32
inputs, are held here against the reference's oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode at the
float32 tolerance of ``tests/test_kernels.py`` (2e-4), on inputs made with
numpy from a seed; the one-term forms (hi.hi alone) must fail it, so the
tolerance sees what the lo halves add.  The kernels themselves are held
against these plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.mamba2_scan import mamba2_scan_pallas  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.kernels import mamba2_scan as scan_kernel  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_kernels.py, float32


def _fails(got, want):
    return not np.allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# flash_attention, the f32 prefill
# ---------------------------------------------------------------------------

# the shapes of tests/test_kernels.py:270 (GQA groups 1-4 over 1-4 KV heads,
# Sq 1-130, Skv - Sq 0-140, both masks), at every head dim the kernel takes
FA_CASES = [
    # b, hkv, group, sq, extra, d, causal
    (1, 2, 2, 130, 140, 64, True),
    (2, 1, 4, 1, 30, 16, True),
    (1, 4, 1, 65, 0, 128, False),
    (2, 2, 2, 77, 3, 32, False),
    (1, 1, 1, 100, 0, 64, True),
    (2, 4, 2, 64, 64, 16, False),
    (1, 2, 4, 129, 7, 32, True),
    (1, 1, 2, 3, 61, 128, True),
    (2, 1, 1, 66, 0, 64, False),
    (1, 4, 4, 2, 0, 128, True),
]


def _fa_inputs(seed, b, hkv, group, sq, extra, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hkv * group, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sq + extra, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sq + extra, d)).astype(np.float32))


def _pairs(q, k, v, causal, terms=3):
    return ref.flash_attention_pairs(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal,
                                     terms=terms).numpy()


@pytest.mark.parametrize("b, hkv, group, sq, extra, d, causal", FA_CASES)
def test_flash_attention_pairs_matches_reference_and_pallas(b, hkv, group, sq,
                                                            extra, d, causal):
    q, k, v = _fa_inputs(sq + extra + d, b, hkv, group, sq, extra, d)
    got = _pairs(q, k, v, causal)
    assert got.dtype == np.float32 and got.shape == q.shape
    np.testing.assert_allclose(got, np.asarray(jref.flash_attention(
        q, k, v, causal=causal)), **TOL)
    np.testing.assert_allclose(got, np.asarray(flash_attention_pallas(
        q, k, v, causal=causal, bq=64, bk=64, interpret=True)), **TOL)


@pytest.mark.parametrize("b, hkv, group, sq, extra, d, causal", FA_CASES)
def test_flash_attention_pairs_one_term_fails_the_tolerance(b, hkv, group, sq,
                                                            extra, d, causal):
    q, k, v = _fa_inputs(sq + extra + d, b, hkv, group, sq, extra, d)
    want = jref.flash_attention(q, k, v, causal=causal)
    assert _fails(_pairs(q, k, v, causal, terms=1), want)


def test_flash_attention_pairs_takes_a_scale_and_checks_terms():
    q, k, v = _fa_inputs(4, 1, 2, 2, 70, 10, 32)
    np.testing.assert_allclose(
        ref.flash_attention_pairs(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), scale=0.3).numpy(),
        np.asarray(jref.flash_attention(q, k, v, scale=0.3)), **TOL)
    with pytest.raises(ValueError, match="terms must be 1"):
        ref.flash_attention_pairs(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), terms=2)


# ---------------------------------------------------------------------------
# mamba2_scan, the f32 route
# ---------------------------------------------------------------------------

def _scan_inputs(seed, b, l, h, p, n, with_h0):
    """x, B and C float32, dt and A as the serve path makes them, and an
    N(0, 1) state or None."""
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(b, l, h, p)).astype(np.float32),
        dt=rng.uniform(0.001, 0.1, size=(b, l, h)).astype(np.float32),
        A=-np.linspace(1.0, 16.0, h).astype(np.float32),
        Bm=rng.normal(size=(b, l, n)).astype(np.float32),
        Cm=rng.normal(size=(b, l, n)).astype(np.float32),
        h0=(rng.normal(size=(b, h, p, n)).astype(np.float32) if with_h0
            else None),
    )


def _chunks(inp, terms=3, dtype=torch.float32):
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in inp.items()}
    return ref.mamba2_scan_chunks(
        t["x"].to(dtype), t["dt"], t["A"], t["Bm"].to(dtype),
        t["Cm"].to(dtype), h0=t["h0"], terms=terms)


def _args(inp):
    return inp["x"], inp["dt"], inp["A"], inp["Bm"], inp["Cm"]


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("p, n", [(64, 64), (16, 16), (8, 16), (16, 8),
                                  (72, 80)])
@pytest.mark.parametrize("l", [1, 63, 65, 300])
def test_f32_scan_plain_matches_reference_and_pallas(l, p, n, with_h0):
    inp = _scan_inputs(l + p + n + with_h0, 2, l, 2, p, n, with_h0)
    y, hN = _chunks(inp)
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, l, 2, p)
    assert hN.dtype == torch.float32 and tuple(hN.shape) == (2, 2, p, n)
    wants = [jref.mamba2_scan(*_args(inp), h0=inp["h0"])]
    if not with_h0:
        wants.append(mamba2_scan_pallas(*_args(inp), cs=64, interpret=True))
    for want_y, want_h in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(hN.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("l, p, n", [(65, 16, 8), (300, 72, 80),
                                     (130, 64, 64)])
def test_f32_scan_one_term_fails_the_tolerance(l, p, n, with_h0):
    inp = _scan_inputs(l + p + n + with_h0, 2, l, 2, p, n, with_h0)
    want_y, want_h = jref.mamba2_scan(*_args(inp), h0=inp["h0"])
    y, hN = _chunks(inp, terms=1)
    # y takes every product of the chunk; the state, a sum of decayed
    # updates, may sit closer to the truth than y does
    assert _fails(y.numpy(), want_y)


def test_f32_scan_plain_continues_its_state():
    """Two halves, the second from the first's state, give the whole."""
    inp = _scan_inputs(5, 1, 200, 2, 16, 16, True)
    y_all, h_all = _chunks(inp)
    cut = 90
    first = dict({k: v[:, :cut] for k, v in inp.items()
                  if k in ("x", "dt", "Bm", "Cm")}, A=inp["A"], h0=inp["h0"])
    y1, h1 = _chunks(first)
    second = dict({k: v[:, cut:] for k, v in inp.items()
                   if k in ("x", "dt", "Bm", "Cm")}, A=inp["A"],
                  h0=h1.numpy())
    y2, h2 = _chunks(second)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(),
                               y_all.numpy(), **TOL)
    np.testing.assert_allclose(h2.numpy(), h_all.numpy(), **TOL)


def _bf16_pair(v):
    hi = v.to(torch.bfloat16).to(torch.float32)
    return hi, (v - hi).to(torch.bfloat16).to(torch.float32)


def _chunk_tc_plain(x, dt, A, Bmat, Cmat, h0, chunk=64):
    """chunk_tc's plain arithmetic as it stood before the float32 route
    shared the function: x, B and C as they are, h, M o S and w o B as bf16
    pairs, two products each."""
    Bsz, L, H, P = x.shape
    N = Bmat.shape[-1]
    xf, Bf, Cf = (t.to(torch.float32) for t in (x, Bmat, Cmat))
    h = (torch.zeros((Bsz, H, P, N)) if h0 is None else h0)
    ys = []
    for t0 in range(0, L, chunk):
        xc, bc, cc = (t[:, t0:t0 + chunk] for t in (xf, Bf, Cf))
        lc = torch.cumsum(A[None, None, :] * dt[:, t0:t0 + chunk], dim=1)
        dc = dt[:, t0:t0 + chunk]
        c = xc.shape[1]
        s_cb = torch.einsum("btn,bsn->bts", cc, bc)
        seg = lc[:, :, None, :] - lc[:, None, :, :]
        tril = torch.tril(torch.ones((c, c), dtype=torch.bool))
        m = torch.where(tril[None, :, :, None],
                        torch.exp(torch.where(tril[None, :, :, None], seg,
                                              0.0)) * dc[:, None, :, :],
                        0.0)
        ms_hi, ms_lo = _bf16_pair(m * s_cb[..., None])
        h_hi, h_lo = _bf16_pair(h)
        z = (torch.einsum("btn,bhpn->bthp", cc, h_hi)
             + torch.einsum("btn,bhpn->bthp", cc, h_lo))
        ys.append(torch.exp(lc)[..., None] * z
                  + torch.einsum("btsh,bshp->bthp", ms_hi, xc)
                  + torch.einsum("btsh,bshp->bthp", ms_lo, xc))
        l_last = lc[:, -1]
        w = torch.exp(l_last[:, None, :] - lc) * dc
        wb_hi, wb_lo = _bf16_pair(w[..., None] * bc[:, :, None, :])
        h = (torch.exp(l_last)[..., None, None] * h
             + torch.einsum("bshn,bshp->bhpn", wb_hi, xc)
             + torch.einsum("bshn,bshp->bhpn", wb_lo, xc))
    return torch.cat(ys, dim=1).to(x.dtype), h


@pytest.mark.parametrize("l, p, n, with_h0", [(65, 16, 8, True),
                                              (300, 72, 80, False),
                                              (2, 64, 64, True)])
def test_bf16_scan_plain_is_bitwise_unchanged(l, p, n, with_h0):
    inp = _scan_inputs(7 + l, 2, l, 3, p, n, with_h0)
    y, hN = _chunks(inp, dtype=torch.bfloat16)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in inp.items()}
    y0, h0 = _chunk_tc_plain(t["x"].to(torch.bfloat16), t["dt"], t["A"],
                             t["Bm"].to(torch.bfloat16),
                             t["Cm"].to(torch.bfloat16), t["h0"])
    assert torch.equal(y.view(torch.int16), y0.view(torch.int16))
    assert torch.equal(hN.view(torch.int32), h0.view(torch.int32))


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq", [2, 64, 1024])
def test_float32_prefill_still_takes_the_f32_route(sq):
    q = torch.empty((8, 32, sq, 64), dtype=torch.float32, device="meta")
    assert flash_attention.route(q) == "f32"


@pytest.mark.parametrize("l, n, want", [(2, 64, "f32"), (1024, 64, "f32"),
                                        (70, 128, "f32"),
                                        (70, 129, "f32_wide"),
                                        (1, 160, "decode"),
                                        (1, 320, "f32_wide")])
def test_float32_scan_routes_by_length_and_width(l, n, want):
    x = torch.zeros((2, l, 3, 8), dtype=torch.float32)
    assert scan_kernel.route(x, n) == want
    assert set(scan_kernel.route_launches) == {"chunk_tc", "decode", "f32",
                                               "f32_wide", "bf16_wide"}
