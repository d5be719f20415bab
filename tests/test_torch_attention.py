"""The port's attention and layers against the reference package's.

On the CPU: the plain flash attention (``repro_torch.kernels.ref``) against
the reference oracle and the reference's Pallas kernel in interpret mode,
over the shape ranges and at the tolerances of ``tests/test_kernels.py``;
the attention cores, with and without a partly filled cache, against the
reference's ``_blocked_core``; and the norms, RoPE and MLPs.  Inputs are
made from a seed with numpy and handed to both packages.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.kernels import flash_attention, ops  # noqa: E402
from repro_torch.kernels import ref as torch_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.models import attention as torch_attn  # noqa: E402
from repro_torch.models import layers as torch_layers  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py:281
BF16_TOL = dict(rtol=5e-2, atol=5e-2)  # tests/test_kernels.py:291


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


# the ranges of tests/test_kernels.py::test_flash_attention_matches_ref
# (b 1-2, hkv 1/2/4, group 1/2/4, sq 1-130, skv - sq 0-140, d 16/64,
# causal or not), drawn once from a fixed seed
def _cases(n, seed=2024):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append((int(rng.integers(1, 3)), int(rng.choice([1, 2, 4])),
                    int(rng.choice([1, 2, 4])), int(rng.integers(1, 131)),
                    int(rng.integers(0, 141)), int(rng.choice([16, 64])),
                    bool(i % 2), i))
    return out


FA_CASES = _cases(12) + [(1, 2, 2, 130, 0, 64, True, 90),
                         (2, 1, 4, 1, 140, 16, True, 91),
                         (1, 4, 1, 64, 64, 32, False, 92),
                         (1, 1, 2, 3, 0, 128, True, 93)]


@pytest.mark.parametrize("b, hkv, group, sq, extra, d, causal, seed",
                         FA_CASES)
def test_plain_flash_attention_matches_reference(b, hkv, group, sq, extra, d,
                                                 causal, seed):
    q, k, v = _qkv(seed, b, hkv * group, hkv, sq, sq + extra, d)
    got = torch_ref.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = np.asarray(jax_ref.flash_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    pallas = np.asarray(flash_attention_pallas(q, k, v, causal=causal, bq=64,
                                               bk=64, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **F32_TOL)
    # ops dispatches CPU tensors to the plain version, without a launch
    before = flash_attention.launches
    again = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert torch.equal(again, got) and flash_attention.launches == before


@pytest.mark.parametrize("shape", [(1, 4, 256, 64, 2), (2, 6, 33, 32, 3)])
def test_plain_flash_attention_bf16(shape):
    b, hq, s, d, hkv = shape
    q, k, v = _qkv(3, b, hq, hkv, s, s, d)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = torch_ref.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    for want in (jax_ref.flash_attention(jq, jk, jv, causal=True),
                 flash_attention_pallas(jq, jk, jv, causal=True,
                                        interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **BF16_TOL)


def test_plain_flash_attention_decode_single_query():
    """Sq = 1 against a long cache (tests/test_kernels.py:297)."""
    q, k, v = _qkv(5, 2, 8, 2, 1, 700, 64)
    got = torch_ref.flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(flash_attention_pallas(
            q, k, v, causal=True, interpret=True)), **F32_TOL)


def test_kernel_mode_and_cuda_wrapper_refuse_cpu_tensors():
    q, k, v = (_t(x) for x in _qkv(0, 1, 2, 1, 4, 4, 16))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.flash_attention(q, k, v, mode="kernel")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_attention_cuda(q, k, v)
    # mode="ref" takes the plain version on any device
    assert torch.equal(ops.flash_attention(q, k, v, mode="ref"),
                       torch_ref.flash_attention(q, k, v))
    with pytest.raises(ValueError, match="unknown mode"):
        ops.flash_attention(q, k, v, mode="fast")


# ---------------------------------------------------------------------------
# attention cores, with and without a partly filled cache
# ---------------------------------------------------------------------------

CORE_CASES = [
    # b, hq, hkv, sq, cache length, kv_len (None: no cache), d, bk
    (2, 4, 2, 24, 24, None, 32, 1024),
    (1, 6, 2, 37, 37, None, 16, 16),
    (2, 4, 1, 1, 64, 41, 32, 1024),      # decode into a partly filled cache
    (1, 12, 4, 1, 96, 96, 64, 32),       # decode at the cache's end
    (2, 4, 2, 8, 48, 24, 32, 16),        # a prefill chunk after 16 cached
    (1, 2, 2, 5, 20, 5, 16, 8),          # the first chunk
]


@pytest.mark.parametrize("b, hq, hkv, sq, skv, kv_len, d, bk", CORE_CASES)
def test_attention_cores_match_reference_blocked_core(b, hq, hkv, sq, skv,
                                                      kv_len, d, bk):
    q, k, v = _qkv(sq * 7 + skv, b, hq, hkv, sq, skv, d)
    scale = 1.0 / d ** 0.5
    want = np.asarray(jax_attn._blocked_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        scale=scale, kv_len=kv_len))
    tq, tk, tv = _t(q), _t(k), _t(v)
    got = {
        "blocked": torch_attn._blocked_core(tq, tk, tv, causal=True,
                                            scale=scale, bk=bk,
                                            kv_len=kv_len),
        "naive": torch_attn._naive_core(tq, tk, tv, causal=True, scale=scale,
                                        kv_len=kv_len),
        "kernel": torch_attn.attention_core(tq, tk, tv, causal=True,
                                            impl="kernel", kv_len=kv_len),
    }
    for name, out in got.items():
        np.testing.assert_allclose(out.numpy(), want, **F32_TOL,
                                   err_msg=name)


def test_kernel_core_reads_the_cache_prefix_only():
    """With kv_len, what lies in the cache past kv_len never matters."""
    q, k, v = (_t(x) for x in _qkv(11, 1, 4, 2, 1, 50, 32))
    base = torch_attn.attention_core(q, k, v, causal=True, impl="kernel",
                                     kv_len=30)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 30:] = 1e4
    v2[:, :, 30:] = float("nan")
    assert torch.equal(base, torch_attn.attention_core(
        q, k2, v2, causal=True, impl="kernel", kv_len=30))


@pytest.mark.parametrize("impl", ["pallas", "flash_decode", "kernel_proxy",
                                  "bogus"])
def test_unported_attention_cores_raise(impl):
    q, k, v = (_t(x) for x in _qkv(0, 1, 2, 1, 4, 4, 16))
    err = ValueError if impl == "bogus" else NotImplementedError
    with pytest.raises(err):
        torch_attn.attention_core(q, k, v, causal=True, impl=impl)


# ---------------------------------------------------------------------------
# norms, RoPE and MLPs
# ---------------------------------------------------------------------------

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _both_cfgs(name, **overrides):
    return (jax_config(name).reduced(**overrides),
            get_any_config(name).reduced(**overrides))


@pytest.mark.parametrize("arch", ["radar-lm-100m", "stablelm-3b"])
def test_apply_norm_matches_reference(arch):
    jcfg, tcfg = _both_cfgs(arch)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, tcfg.d_model)).astype(np.float32) * 3.0
    p = {"scale": rng.normal(size=(tcfg.d_model,)).astype(np.float32)}
    if tcfg.norm == "layernorm":
        p["bias"] = rng.normal(size=(tcfg.d_model,)).astype(np.float32)
    want = jax_layers.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in
                                        p.items()}, jnp.asarray(x))
    got = torch_layers.apply_norm(tcfg, {k: _t(v) for k, v in p.items()},
                                  _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    # bfloat16 in, float32 inside, bfloat16 out
    xb = _t(x).to(torch.bfloat16)
    assert torch_layers.apply_norm(tcfg, {k: _t(v) for k, v in p.items()},
                                   xb).dtype == torch.bfloat16


@pytest.mark.parametrize("fraction, theta", [(1.0, 10_000.0),
                                             (0.25, 10_000.0),
                                             (1.0, 500_000.0)])
def test_apply_rope_matches_reference(fraction, theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 11, 32)).astype(np.float32)
    pos = np.stack([np.arange(11), np.arange(40, 51)]).astype(np.int32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                                 fraction)
    got = torch_layers.apply_rope(_t(x), _t(pos), theta, fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_apply_mlp_matches_reference(mlp):
    jcfg, tcfg = _both_cfgs("radar-lm-100m")
    jcfg = dataclasses.replace(jcfg, mlp=mlp)
    tcfg = dataclasses.replace(tcfg, mlp=mlp)
    rng = np.random.default_rng(3)
    d, f = tcfg.d_model, tcfg.d_ff
    names = {"swiglu": {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)},
             "gelu": {"w_up": (d, f), "b_up": (f,), "w_down": (f, d),
                      "b_down": (d,)}}[mlp]
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in names.items()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    want = jax_layers.apply_mlp(jcfg, {k: jnp.asarray(v) for k, v in
                                       p.items()}, jnp.asarray(x))
    got = torch_layers.apply_mlp(tcfg, {k: _t(v) for k, v in p.items()},
                                 _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
