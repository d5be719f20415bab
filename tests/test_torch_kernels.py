"""The port's kernels against the reference package's, on the same inputs.

On the CPU the port's plain PyTorch versions (``repro_torch.kernels.ref``,
which ``ops`` dispatches to for CPU tensors) are held against the
reference oracles (``repro.kernels.ref``) and against the reference's
Pallas kernels in interpret mode, over the shape sweeps and at the
tolerances of ``tests/test_kernels.py``.  The hand-written CUDA kernels
have no CPU mode: ``tests/test_torch_kernels_cuda.py`` holds them against
their plain versions on a GPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, strategies as st  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.qvp_reduce import qvp_reduce_pallas  # noqa: E402
from repro.kernels.zr_accum import zr_accum_pallas  # noqa: E402
from repro_torch.kernels import ops, qvp_reduce, zr_accum  # noqa: E402
from repro_torch.kernels import ref as torch_ref  # noqa: E402
from repro_torch.kernels.qvp_reduce import qvp_reduce_cuda  # noqa: E402
from repro_torch.kernels.zr_accum import zr_accum_cuda  # noqa: E402

QVP_TOL = dict(rtol=1e-5, atol=1e-5)
QPE_TOL = dict(rtol=1e-4, atol=1e-5)


def _radar_field(rng, t, a, r, nan_frac=0.15):
    f = rng.normal(20.0, 12.0, size=(t, a, r)).astype(np.float32)
    f[rng.random((t, a, r)) < nan_frac] = np.nan
    return f


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# qvp_reduce
# ---------------------------------------------------------------------------

@given(
    t=st.integers(1, 9),
    a=st.integers(4, 48),
    r=st.integers(3, 300),
    seed=st.integers(0, 999),
)
@settings(max_examples=20, deadline=None)
def test_qvp_reduce_matches_reference(t, a, r, seed):
    rng = np.random.default_rng(seed)
    field = _radar_field(rng, t, a, r)
    quality = rng.uniform(0.5, 1.0, size=(t, a, r)).astype(np.float32)
    got = ops.qvp_reduce(_t(field), _t(quality)).numpy()
    np.testing.assert_allclose(got, jax_ref.qvp_reduce(field, quality),
                               **QVP_TOL)
    np.testing.assert_allclose(
        got, qvp_reduce_pallas(field, quality, bt=4, br=128, interpret=True),
        **QVP_TOL)


def test_qvp_reduce_no_quality_path():
    rng = np.random.default_rng(0)
    field = _radar_field(rng, 4, 360, 250)
    got = ops.qvp_reduce(_t(field), None).numpy()
    np.testing.assert_allclose(got, jax_ref.qvp_reduce(field, None),
                               **QVP_TOL)
    np.testing.assert_allclose(
        got, qvp_reduce_pallas(field, field, quality_min=float("-inf"),
                               interpret=True), **QVP_TOL)


def test_qvp_reduce_all_invalid_row_is_nan():
    field = np.full((2, 8, 16), np.nan, dtype=np.float32)
    out = ops.qvp_reduce(_t(field), _t(np.ones_like(field)))
    assert torch.isnan(out).all()


@pytest.mark.parametrize("n_valid, expect_nan", [(72, False), (71, True)])
def test_qvp_reduce_valid_fraction_boundary(n_valid, expect_nan):
    """The main path's boundary: a row with exactly 0.1 * 720 = 72 valid
    azimuths keeps its mean (the comparison is inclusive, against the
    threshold as a float32, as in the reference); 71 gives NaN."""
    field = np.full((2, 720, 5), np.nan, dtype=np.float32)
    field[:, :n_valid, :] = 30.0
    quality = np.ones_like(field)
    got = ops.qvp_reduce(_t(field), _t(quality)).numpy()
    want = np.asarray(jax_ref.qvp_reduce(field, quality))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).all() == expect_nan
    if not expect_nan:
        np.testing.assert_array_equal(got, 30.0)


# ---------------------------------------------------------------------------
# zr_accum
# ---------------------------------------------------------------------------

@given(
    t=st.integers(1, 12),
    a=st.integers(2, 40),
    r=st.integers(2, 300),
    seed=st.integers(0, 999),
)
@settings(max_examples=20, deadline=None)
def test_zr_accum_matches_reference(t, a, r, seed):
    rng = np.random.default_rng(seed)
    dbz = _radar_field(rng, t, a, r)
    dt_s = rng.uniform(200.0, 400.0, size=(t,)).astype(np.float32)
    got = ops.zr_accum(_t(dbz), _t(dt_s)).numpy()
    np.testing.assert_allclose(got, jax_ref.zr_accum(dbz, dt_s), **QPE_TOL)
    np.testing.assert_allclose(
        got, zr_accum_pallas(dbz, dt_s, bt=4, ba=16, br=128, interpret=True),
        **QPE_TOL)


def test_zr_accum_zero_below_threshold():
    dbz = np.full((3, 4, 8), -5.0, dtype=np.float32)
    out = ops.zr_accum(_t(dbz), _t(np.full(3, 300.0, np.float32)))
    np.testing.assert_array_equal(out.numpy(), 0.0)


def test_zr_accum_known_value():
    """40 dBZ for one hour under Marshall-Palmer ≈ 11.53 mm."""
    dbz = np.full((1, 1, 1), 40.0, dtype=np.float32)
    out = ops.zr_accum(_t(dbz), _t(np.array([3600.0], np.float32)))
    expected = (1e4 / 200.0) ** (1 / 1.6)
    np.testing.assert_allclose(out.numpy()[0, 0], expected, rtol=1e-4)


# ---------------------------------------------------------------------------
# dispatch: no CPU fallback for the kernels
# ---------------------------------------------------------------------------

def test_kernel_mode_on_cpu_tensor_raises():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.qvp_reduce(x, x, mode="kernel")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.zr_accum(x, torch.ones(2), mode="kernel")
    with pytest.raises(ValueError, match="unknown mode"):
        ops.qvp_reduce(x, x, mode="fast")


def test_wrappers_reject_cpu_tensors():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        qvp_reduce_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        zr_accum_cuda(x, torch.ones(2))


def test_auto_on_cpu_uses_plain_version_and_launches_nothing():
    rng = np.random.default_rng(1)
    field = _t(_radar_field(rng, 3, 16, 40))
    before = (qvp_reduce.launches, zr_accum.launches)
    got = ops.qvp_reduce(field, None)
    assert torch.equal(torch.isnan(got),
                       torch.isnan(torch_ref.qvp_reduce(field, None)))
    ops.zr_accum(field, torch.full((3,), 300.0))
    assert (qvp_reduce.launches, zr_accum.launches) == before
