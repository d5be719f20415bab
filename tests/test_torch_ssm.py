"""The port's Mamba-2 scan and mixer against the reference package's, on
the CPU.

The same inputs, made from a seed with numpy, go through both packages:
the plain ``mamba2_scan`` against the reference's sequential oracle and
its Pallas kernel in interpret mode, with and without a starting state;
the plain chunked SSD; and one Mamba-2 block (``apply_mamba2``) for each
impl, with and without a decode state, the new states included.  On a CPU
tensor the port's kernel route (``impl="kernel"``) runs the plain
version; the kernel itself is held against it on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba2_scan import mamba2_scan_pallas  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.kernels import mamba2_scan as scan_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_kernels.py:330-331
BLOCK_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_serve.py:33


def _scan_inputs(seed, b, l, h, p, n, with_h0=False):
    rng = np.random.default_rng(seed)
    out = dict(
        x=rng.normal(size=(b, l, h, p)).astype(np.float32),
        dt=rng.uniform(0.001, 0.1, size=(b, l, h)).astype(np.float32),
        A=-rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32),
        Bm=rng.normal(size=(b, l, n)).astype(np.float32),
        Cm=rng.normal(size=(b, l, n)).astype(np.float32),
    )
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if with_h0 \
        else None
    return out, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _scan(inp, h0=None):
    return ref.mamba2_scan(_t(inp["x"]), _t(inp["dt"]), _t(inp["A"]),
                           _t(inp["Bm"]), _t(inp["Cm"]), h0=_t(h0))


# seeded shapes over the reference test's ranges: b 1-2, l 1-200,
# h {1, 2, 4}, p and n {8, 16}
_SHAPES = [(seed, int(r.integers(1, 3)), int(r.integers(1, 201)),
            int(r.choice([1, 2, 4])), int(r.choice([8, 16])),
            int(r.choice([8, 16])))
           for seed, r in ((s, np.random.default_rng(100 + s))
                           for s in range(6))]
_SHAPES.append((6, 1, 1, 2, 8, 16))           # one token, as in decode
_SHAPES.append((7, 2, 128, 4, 16, 8))         # two whole Pallas chunks


@pytest.mark.parametrize("seed, b, l, h, p, n", _SHAPES)
def test_plain_scan_matches_reference_and_pallas_kernel(seed, b, l, h, p, n):
    inp, _ = _scan_inputs(seed, b, l, h, p, n)
    y, hN = _scan(inp)
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, l, h, p)
    assert hN.dtype == torch.float32 and tuple(hN.shape) == (b, h, p, n)
    args = (inp["x"], inp["dt"], inp["A"], inp["Bm"], inp["Cm"])
    y_ref, h_ref = jref.mamba2_scan(*args)
    y_pal, h_pal = mamba2_scan_pallas(*args, cs=64, interpret=True)
    for want_y, want_h in ((y_ref, h_ref), (y_pal, h_pal)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
        np.testing.assert_allclose(hN.numpy(), np.asarray(want_h),
                                   **SCAN_TOL)


@pytest.mark.parametrize("seed, b, l, h, p, n",
                         [(11, 2, 37, 2, 16, 8), (12, 1, 1, 4, 8, 8),
                          (13, 1, 150, 1, 16, 16)])
def test_plain_scan_from_a_state_matches_reference(seed, b, l, h, p, n):
    inp, h0 = _scan_inputs(seed, b, l, h, p, n, with_h0=True)
    y, hN = _scan(inp, h0)
    y_ref, h_ref = jref.mamba2_scan(inp["x"], inp["dt"], inp["A"],
                                    inp["Bm"], inp["Cm"], h0=h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **SCAN_TOL)
    np.testing.assert_allclose(hN.numpy(), np.asarray(h_ref), **SCAN_TOL)
    # the dispatch: a CPU tensor takes the plain version, with its h0
    before = scan_kernel.launches
    y_ops, h_ops = ops.mamba2_scan(_t(inp["x"]), _t(inp["dt"]), _t(inp["A"]),
                                   _t(inp["Bm"]), _t(inp["Cm"]), h0=_t(h0))
    assert scan_kernel.launches == before
    assert torch.equal(y_ops, y) and torch.equal(h_ops, hN)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        ops.mamba2_scan(_t(inp["x"]), _t(inp["dt"]), _t(inp["A"]),
                        _t(inp["Bm"]), _t(inp["Cm"]), mode="kernel")


def test_plain_scan_state_continuation():
    """Scanning [first half] then [second half from its state] equals the
    whole scan (the counterpart of tests/test_kernels.py:334)."""
    inp, _ = _scan_inputs(14, 1, 64, 2, 8, 8)
    y_full, h_full = _scan(inp)
    half = 32
    first = {k: v if k == "A" else v[:, :half] for k, v in inp.items()}
    second = {k: v if k == "A" else v[:, half:] for k, v in inp.items()}
    y1, h1 = _scan(first)
    y2, h2 = _scan(second, h1.numpy())
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(),
                               y_full.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("l, chunk", [(40, 16), (64, 32), (7, 32)])
def test_chunked_ssd_matches_reference(l, chunk):
    inp, _ = _scan_inputs(15 + l, 2, l, 4, 16, 8)
    got = ssm._chunked_ssd(_t(inp["x"]), _t(inp["dt"]), _t(inp["A"]),
                           _t(inp["Bm"]), _t(inp["Cm"]), chunk)
    want = jssm._chunked_ssd_jnp(jnp.asarray(inp["x"]), jnp.asarray(inp["dt"]),
                                 jnp.asarray(inp["A"]), jnp.asarray(inp["Bm"]),
                                 jnp.asarray(inp["Cm"]), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    y_seq, _ = _scan(inp)
    np.testing.assert_allclose(got.numpy(), y_seq.numpy(), **SCAN_TOL)


# ---------------------------------------------------------------------------
# one Mamba-2 block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    jcfg = jax_config("zamba2-1.2b").reduced()
    tcfg = get_any_config("zamba2-1.2b").reduced()
    jp = jssm.init_mamba2(jcfg, jax.random.key(3), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


# the port's impl -> the reference's
_IMPLS = [("kernel", "pallas"), ("chunked", "chunked"), ("ref", "ref")]


@pytest.mark.parametrize("impl, jimpl", _IMPLS)
@pytest.mark.parametrize("with_state", [False, True])
def test_apply_mamba2_matches_reference(block, impl, jimpl, with_state):
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 19, tcfg.d_model)).astype(np.float32)
    jstate = tstate = None
    if with_state:
        s, d_inner, H = ssm._dims(tcfg)
        ssm0 = rng.normal(size=(2, H, s.head_dim, s.d_state)).astype(
            np.float32)
        conv0 = rng.normal(size=(2, s.conv_width - 1,
                                 d_inner + 2 * s.d_state)).astype(np.float32)
        jstate = {"ssm": jnp.asarray(ssm0), "conv": jnp.asarray(conv0)}
        tstate = {"ssm": torch.from_numpy(ssm0.copy()),
                  "conv": torch.from_numpy(conv0.copy())}
    want, jnew = jssm.apply_mamba2(jcfg, jp, jnp.asarray(x), state=jstate,
                                   impl=jimpl)
    got, tnew = ssm.apply_mamba2(tcfg, tp, torch.from_numpy(x), state=tstate,
                                 impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    if not with_state:
        assert tnew is None and jnew is None
        return
    # the new states are written over the given ones, in place
    assert tnew is tstate
    for name in ("ssm", "conv"):
        assert tnew[name].dtype == torch.float32
        np.testing.assert_allclose(tnew[name].numpy(),
                                   np.asarray(jnew[name]), **BLOCK_TOL)


def test_decode_state_has_no_sequence_axis():
    """The counterpart of tests/test_archs.py:160-170: a Mamba-2 layer's
    cache is a constant-size state, whatever max_len is."""
    from repro_torch.configs.base import ParallelConfig

    cfg = get_any_config("zamba2-1.2b").reduced()
    pcfg = ParallelConfig(compute_dtype="float32", kv_cache_dtype="bfloat16")
    caches = M.init_caches(cfg, pcfg, batch=2, max_len=10_000, device="meta")
    s, d_inner, H = ssm._dims(cfg)
    ssm_caches = [c for group in caches for c in group if "ssm" in c]
    assert ssm_caches, "zamba2 must carry SSM states"
    for c in ssm_caches:
        reps = c["ssm"].shape[0]
        assert tuple(c["ssm"].shape) == (reps, 2, H, s.head_dim, s.d_state)
        assert tuple(c["conv"].shape) == (reps, 2, s.conv_width - 1,
                                          d_inner + 2 * s.d_state)
        assert c["ssm"].dtype == c["conv"].dtype == torch.float32
        assert 10_000 not in c["ssm"].shape and 10_000 not in c["conv"].shape
    kv = [c for group in caches for c in group if "k" in c]
    assert kv and all(c["k"].shape[3] == 10_000 and
                      c["k"].dtype == torch.bfloat16 for c in kv)
