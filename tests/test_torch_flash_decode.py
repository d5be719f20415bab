"""The split-key decode of the port's ``flash_attention`` and its routes.

On the CPU: ``repro_torch.kernels.ref.flash_decode`` (the plain version of
the decode kernel, ``csrc/flash_decode.cu``) against the reference's
split-key decode core (``repro.models.attention._flash_decode_core`` with
``n_chunks``) and against ``ref.flash_attention``, whose function every
route computes; the decode kernel's split count; and the choice of route,
which depends on the dtype and Sq alone.  Inputs are made from a seed with
numpy and handed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jax_attn  # noqa: E402
from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _qkv(seed, b, hq, hkv, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, 1, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# ref.flash_decode against the reference's split-key decode core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b, hq, hkv, s, n, kv_len", [
    (2, 12, 4, 128, 4, None), (2, 12, 4, 128, 4, 100),
    (1, 4, 4, 96, 3, None), (3, 8, 2, 256, 8, 200),
    (1, 2, 1, 64, 2, 1), (2, 32, 32, 64, 1, 40)])
def test_flash_decode_matches_reference_decode_core(b, hq, hkv, s, n, kv_len):
    q, k, v = _qkv(s + n, b, hq, hkv, s, 64)
    scale = 0.125
    want = np.asarray(jax_attn._flash_decode_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        kv_len=kv_len, n_chunks=n))
    # the reference masks keys >= kv_len inside its chunks of the whole
    # cache; the port's decode takes the prefix itself
    m = s if kv_len is None else kv_len
    got = ref.flash_decode(_t(q), _t(k[:, :, :m]), _t(v[:, :, :m]), n, scale)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


# ---------------------------------------------------------------------------
# ref.flash_decode against ref.flash_attention, the function of every route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [1, 2, 3, 4])
@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5, 6, 7, 8])
def test_flash_decode_equals_attention_for_every_split(n_split, group):
    # 517 keys: every split count leaves a ragged last split, and the keys
    # are the prefix of a 600-long cache
    hkv, kv_len = 2, 517
    q, k, v = _qkv(10 * n_split + group, 2, hkv * group, hkv, 600, 32)
    k, v = _t(k)[:, :, :kv_len], _t(v)[:, :, :kv_len]
    got = ref.flash_decode(_t(q), k, v, n_split)
    want = ref.flash_attention(_t(q), k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


@pytest.mark.parametrize("skv, n_split", [(1, 1), (5, 4), (9, 8), (64, 8)])
def test_flash_decode_takes_empty_and_tiny_splits(skv, n_split):
    # ceil(skv / n_split) keys a split can leave the last splits empty:
    # they weigh nothing in the merge
    q, k, v = (_t(x) for x in _qkv(skv, 1, 6, 3, skv, 16))
    got = ref.flash_decode(q, k, v, n_split, scale=0.3)
    want = ref.flash_attention(q, k, v, causal=False, scale=0.3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_flash_decode_bf16_rounds_once_and_refuses_many_queries():
    q, k, v = (_t(x).to(torch.bfloat16) for x in _qkv(3, 2, 8, 2, 300, 64))
    got = ref.flash_decode(q, k, v, 5)
    assert got.dtype == torch.bfloat16
    want = ref.flash_attention(q.float(), k.float(), v.float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError, match="one query"):
        ref.flash_decode(q.expand(2, 8, 3, 64), k, v, 2)


# ---------------------------------------------------------------------------
# the decode kernel's split count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh, skv, want", [
    (8 * 4, 1056, 5),       # radar-lm decode: 160 blocks on 132 SMs
    (8 * 32, 1056, 1),      # zamba2's shared block: 256 blocks already
    (32, 63, 1),            # fewer than 64 keys: one split
    (32, 64, 1),
    (32, 191, 2),           # at least 64 keys a split
    (132, 4096, 1),         # B * Hkv >= the SM count
    (500, 4096, 1),
    (1, 100000, 8),         # at most 8 (the portable cluster)
    (17, 4096, 8),
    (66, 4096, 2)])
def test_decode_splits(bh, skv, want):
    n = flash_attention.decode_splits(bh, skv, H100_SMS)
    assert n == want
    assert 1 <= n <= flash_attention.MAX_SPLIT
    assert n == 1 or skv // n >= flash_attention.MIN_SPLIT_KEYS
    # the fewest splits that cover the SMs, where the keys allow
    if n < min(flash_attention.MAX_SPLIT,
               skv // flash_attention.MIN_SPLIT_KEYS):
        assert bh * n >= H100_SMS and (n == 1 or bh * (n - 1) < H100_SMS)


# ---------------------------------------------------------------------------
# the route: from the dtype and Sq alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", [1, 2, 64, 1024])
def test_route_depends_on_dtype_and_sq_alone(sq, dtype):
    q = torch.empty((8, 12, sq, 64), dtype=dtype, device="meta")
    want = ("decode" if sq == 1 else
            "tc_prefill" if dtype == torch.bfloat16 else "f32")
    assert flash_attention.route(q) == want
    # batch, heads and width do not move it
    assert flash_attention.route(q[:1, :2, :, :16]) == want
    assert set(flash_attention.route_launches) == {"decode", "tc_prefill",
                                                   "f32"}


class _CudaLike:
    """Stands in for a CUDA tensor where the dispatch only reads the device."""

    device = torch.device("cuda")
    dtype = torch.bfloat16
    shape = (1, 2, 1, 16)


@pytest.mark.parametrize("mode", ["auto", "kernel"])
def test_a_cuda_tensor_never_takes_the_plain_version(monkeypatch, mode):
    calls = []

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(ops.ref, "flash_attention", plain)
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        lambda *a, **kw: calls.append(a) or "kernel")
    x = _CudaLike()
    assert ops.flash_attention(x, x, x, mode=mode) == "kernel"
    assert len(calls) == 1


def test_cuda_wrapper_refuses_cpu_tensors_without_counting():
    q, k, v = (_t(x) for x in _qkv(0, 1, 2, 1, 8, 16))
    before = dict(flash_attention.route_launches)
    n = flash_attention.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_attention.flash_attention_cuda(q, k, v)
    assert flash_attention.launches == n
    assert flash_attention.route_launches == before
