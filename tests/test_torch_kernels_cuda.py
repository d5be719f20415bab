"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device (the kernels have no CPU or interpret
mode): they carry the ``cuda`` marker and skip without one.  The file
imports nothing of JAX, so it runs where the GPU is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, qvp_reduce, zr_accum  # noqa: E402
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
