"""The routes of the port's Mamba-2 scan, and the plain version of its
tensor-core route, against the reference package's, on the CPU.

``kernels/mamba2_scan.py`` sends a scan to one of three kernels from the
dtype and L alone (``route``).  The tensor-core route (``chunk_tc``,
bfloat16 with L > 1) computes the chunked form with its own operand
roundings: x, B and C exact in bf16, every float32 operand of the tensor
cores (h, M o S, w o B) as a bf16 hi + lo pair.  Its plain version,
``ref.mamba2_scan_chunks``, does the same in float32 on the CPU; here it
is held against the reference's sequential oracle (from a state and from
zeros) and its Pallas kernel in interpret mode (from zeros: the Pallas
kernel takes no state), at ragged lengths and at the widths of the
kernel's tests, on inputs made with numpy from a seed and rounded to
bf16.  The kernels themselves are held against these plain versions on
the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba2_scan import mamba2_scan_pallas  # noqa: E402
from repro_torch.kernels import mamba2_scan as scan_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# y: one bf16 rounding of y in each version (2**-7 of |y| at most) below
# 1e-2; the float32 state at tests/test_kernels.py:330-331
Y_TOL = dict(rtol=1e-2, atol=1e-2)
STATE_TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, b, l, h, p, n, with_h0):
    """x, B and C rounded to bf16 (the kernel's inputs; as float32 arrays
    for the reference), dt and A as the serve path makes them, and an
    N(0, 1) state or None."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(torch.bfloat16).to(torch.float32).numpy()

    return dict(
        x=bf16((b, l, h, p)),
        dt=rng.uniform(0.001, 0.1, size=(b, l, h)).astype(np.float32),
        A=-np.linspace(1.0, 16.0, h).astype(np.float32),
        Bm=bf16((b, l, n)),
        Cm=bf16((b, l, n)),
        h0=(rng.normal(size=(b, h, p, n)).astype(np.float32) if with_h0
            else None),
    )


def _chunks(inp):
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in inp.items()}
    return ref.mamba2_scan_chunks(
        t["x"].to(torch.bfloat16), t["dt"], t["A"],
        t["Bm"].to(torch.bfloat16), t["Cm"].to(torch.bfloat16), h0=t["h0"])


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("p, n", [(64, 64), (16, 16), (8, 16), (16, 8),
                                  (72, 80)])
@pytest.mark.parametrize("l", [1, 63, 65, 300])
def test_chunk_scan_plain_matches_reference_and_pallas(l, p, n, with_h0):
    inp = _inputs(l + p + n + with_h0, 2, l, 2, p, n, with_h0)
    y, hN = _chunks(inp)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (2, l, 2, p)
    assert hN.dtype == torch.float32 and tuple(hN.shape) == (2, 2, p, n)
    args = (inp["x"], inp["dt"], inp["A"], inp["Bm"], inp["Cm"])
    wants = [jref.mamba2_scan(*args, h0=inp["h0"])]
    if not with_h0:
        wants.append(mamba2_scan_pallas(*args, cs=64, interpret=True))
    for want_y, want_h in wants:
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y),
                                   **Y_TOL)
        np.testing.assert_allclose(hN.numpy(), np.asarray(want_h),
                                   **STATE_TOL)


def test_chunk_scan_plain_continues_its_state():
    """Two halves, the second from the first's state, give the whole (the
    counterpart of tests/test_kernels.py:334 for the chunked form)."""
    inp = _inputs(5, 1, 200, 2, 16, 16, True)
    y_all, h_all = _chunks(inp)
    cut = 90
    first = dict({k: v[:, :cut] for k, v in inp.items()
                  if k in ("x", "dt", "Bm", "Cm")}, A=inp["A"], h0=inp["h0"])
    y1, h1 = _chunks(first)
    second = dict({k: v[:, cut:] for k, v in inp.items()
                   if k in ("x", "dt", "Bm", "Cm")}, A=inp["A"],
                  h0=h1.numpy())
    y2, h2 = _chunks(second)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).float().numpy(),
                               y_all.float().numpy(), **Y_TOL)
    np.testing.assert_allclose(h2.numpy(), h_all.numpy(), **STATE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 2, 64, 1000])
def test_route_follows_dtype_and_length(l, dtype):
    x = torch.zeros((2, l, 3, 8), dtype=dtype)
    want = ("decode" if l == 1 else
            "chunk_tc" if dtype == torch.bfloat16 else "f32")
    assert scan_kernel.route(x) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 70])
def test_kernel_mode_raises_on_a_cpu_tensor(l, dtype):
    inp = _inputs(9, 1, l, 2, 8, 8, True)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x, Bm, Cm = (t[k].to(dtype) for k in ("x", "Bm", "Cm"))
    before = (scan_kernel.launches, dict(scan_kernel.route_launches))
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        ops.mamba2_scan(x, t["dt"], t["A"], Bm, Cm, h0=t["h0"],
                        mode="kernel")
    # "auto" takes the plain version on the CPU and launches nothing
    y, hN = ops.mamba2_scan(x, t["dt"], t["A"], Bm, Cm, h0=t["h0"])
    y_ref, h_ref = ref.mamba2_scan(x, t["dt"], t["A"], Bm, Cm, h0=t["h0"])
    assert torch.equal(y, y_ref) and torch.equal(hN, h_ref)
    assert (scan_kernel.launches, scan_kernel.route_launches) == before
