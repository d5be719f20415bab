"""Head dims off the powers of two, and the bf16 scan wider than 128, on the CPU.

The attention kernels take every head dim that is a multiple of 16 up to
128 (``kernels.flash_attention.HEAD_DIMS``); ``stablelm-3b`` at full width
has D = 2560 / 32 = 80.  Here the port's plain attention
(``ref.flash_attention`` and the pair form ``ref.flash_attention_pairs``)
at D in {48, 80, 96} is held against the reference oracle and its Pallas
kernel in interpret mode, a reduced ``stablelm-3b`` with ``d_head=80``
runs through both packages on parameters carried across by
``models.convert``, and the bf16 plain scan at N = 192 (the ``bf16_wide``
route's width) is held against the reference.  The CUDA kernels at these
widths are in ``tests/test_torch_kernels_cuda.py``, marked ``cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.configs.base import ParallelConfig as JaxPCfg  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.mamba2_scan import mamba2_scan_pallas  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.kernels import flash_attention, mamba2_scan, ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py:281
BF16_TOL = dict(rtol=5e-2, atol=5e-2)  # tests/test_kernels.py:291
LM_TOL = dict(rtol=2e-3, atol=2e-3)    # tests/test_serve.py:33
PCFG = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                      remat="none")
JPCFG = JaxPCfg(compute_dtype="float32", kv_cache_dtype="float32",
                remat="none")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def test_head_dims_are_the_multiples_of_16_up_to_128():
    assert flash_attention.HEAD_DIMS == tuple(range(16, 129, 16))


@pytest.mark.parametrize("d", [48, 80, 96])
@pytest.mark.parametrize("b, hkv, group, sq, extra, causal", [
    (1, 2, 2, 130, 0, True), (2, 1, 4, 1, 140, True),
    (1, 4, 1, 65, 7, False), (2, 2, 1, 64, 64, True)])
def test_plain_attention_at_head_dims_off_powers_of_two(b, hkv, group, sq,
                                                        extra, causal, d):
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


@pytest.mark.parametrize("d", [48, 80, 96])
def test_plain_attention_bf16_at_head_dims_off_powers_of_two(d):
    q, k, v = _qkv(d, 2, 4, 2, 70, 70, d)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = ref.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    for want in (jax_ref.flash_attention(jq, jk, jv, causal=True),
                 flash_attention_pallas(jq, jk, jv, causal=True,
                                        interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **BF16_TOL)


# ---------------------------------------------------------------------------
# stablelm-3b at its head dim, 80
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stablelm80():
    jcfg = jax_config("stablelm-3b").reduced(d_head=80)
    tcfg = get_any_config("stablelm-3b").reduced(d_head=80)
    assert tcfg.d_head == jcfg.d_head == 80
    jparams = JM.init_params(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, from_reference(tcfg, tree, device="cpu")


def test_stablelm_d80_forward_matches_reference(stablelm80):
    jcfg, tcfg, jparams, tparams = stablelm80
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(2, 40)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks)}
    want, _ = JM.forward(jcfg, JPCFG, jparams, jbatch, attn_impl="pallas")
    for impl in ("kernel", "blocked"):
        got, _ = M.forward(tcfg, PCFG, tparams, {"tokens": toks},
                           attn_impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)


def test_stablelm_d80_greedy_tokens_match_reference(stablelm80):
    jcfg, tcfg, jparams, tparams = stablelm80
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, tcfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (12, 9)]
    new = 5
    jout = JaxEngine(jcfg, JPCFG, jparams, max_len=32).generate(
        [JaxRequest(p, max_new_tokens=new) for p in prompts], seed=1)
    tout = Engine(tcfg, PCFG, tparams, max_len=32, device="cpu").generate(
        [Request(p, max_new_tokens=new) for p in prompts], seed=1)
    for p, j, t in zip(prompts, jout, tout):
        # tokens equal up to the first step whose top-1/top-2 margin is
        # within the forward pass's tolerance (there the argmax may flip)
        pad = np.zeros(t.prompt_len - len(p), np.int32)
        seq = np.concatenate([pad, p, np.asarray(j.tokens, np.int32)])
        logits, _ = M.forward(tcfg, PCFG, tparams,
                              {"tokens": torch.from_numpy(seq)[None]},
                              attn_impl="kernel")
        top2 = torch.topk(logits[0], 2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1])[t.prompt_len - 1:-1]
        low = torch.nonzero(margins <= LM_TOL["atol"])
        n_safe = int(low[0]) if len(low) else new
        assert n_safe >= 3, f"margins {margins.tolist()}"
        np.testing.assert_array_equal(np.asarray(t.tokens)[:n_safe],
                                      np.asarray(j.tokens)[:n_safe])


# ---------------------------------------------------------------------------
# the bf16 scan wider than the tensor-core route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l, p, n, with_h0", [(70, 16, 192, True),
                                              (130, 136, 16, False),
                                              (1, 8, 320, True)])
def test_bf16_plain_scan_wider_than_128_matches_reference(l, p, n, with_h0):
    rng = np.random.default_rng(l + p + n)
    b, h = 2, 2
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, l, h)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)
    Bm = rng.normal(size=(b, l, n)).astype(np.float32)
    Cm = rng.normal(size=(b, l, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if with_h0 \
        else None
    tx, tB, tC = (_t(a).to(torch.bfloat16) for a in (x, Bm, Cm))
    # the route the card takes for these widths: the CUDA-core kernel
    assert mamba2_scan.route(tx, n) == "bf16_wide"
    y, hN = ops.mamba2_scan(tx, _t(dt), _t(A), tB, tC,
                            h0=None if h0 is None else _t(h0))
    assert y.dtype == torch.bfloat16 and hN.dtype == torch.float32
    jx, jB, jC = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, Bm, Cm))
    y_ref, h_ref = jax_ref.mamba2_scan(jx, dt, A, jB, jC, h0=h0)
    # y: one bf16 rounding in each package; the float32 state at 2e-4
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_ref, np.float32), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(hN.numpy(), np.asarray(h_ref), rtol=2e-4,
                               atol=2e-4)
    if h0 is None and l > 1:
        y_pal, _ = mamba2_scan_pallas(jx, dt, A, jB, jC, cs=64,
                                      interpret=True)
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(y_pal, np.float32), rtol=1e-2,
                                   atol=1e-2)
