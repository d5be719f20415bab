"""The mesh's decode core and the costing probe's core against the
reference's.

``_flash_decode_core`` with ``n_chunks`` 2, 4 and 8 agrees with the
reference's at kv_len 64, 37 and 1 (``tests/test_serve.py``'s check,
``rtol=1e-5, atol=1e-6``) and with the blocked core; the
sequence-sharded combine under gloo at world 2 and 4 (the cache's keys
over ``model``, at world 4 also its batch over ``data``) agrees with the
single-process result within 1e-6; ``decode_step(attn_impl=
"flash_decode")`` of radar-lm (GQA) and deepseek-v2-lite (MLA) agrees
with the reference's within 2e-3; a reduced model
served with DTensor parameters and caches on a mesh of 2 (prefill, then
flash-decode steps on the sharded cache) agrees with the same model
unmeshed; ``_kernel_proxy_core`` equals the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_spawn import (flash_decode_worker, run_ranks,  # noqa: E402
                          serve_worker)
from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.configs.base import ParallelConfig as JaxPCfg  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import prefill as jprefill  # noqa: E402
from repro.serve.engine import decode as jdecode  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve.engine import decode as tdecode  # noqa: E402
from repro_torch.serve.engine import prefill as tprefill  # noqa: E402

B, HQ, HKV, S, D = 2, 8, 4, 64, 16


def _qkv(seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, HQ, 1, D)).astype(np.float32),
            rng.normal(size=(b, HKV, s, D)).astype(np.float32),
            rng.normal(size=(b, HKV, s, D)).astype(np.float32))


@pytest.mark.parametrize("kv_len", [64, 37, 1])
@pytest.mark.parametrize("n_chunks", [2, 4, 8])
def test_flash_decode_core_matches_the_reference(n_chunks, kv_len):
    q, k, v = _qkv()
    got = A._flash_decode_core(*(torch.from_numpy(x) for x in (q, k, v)),
                               scale=0.25, kv_len=kv_len, n_chunks=n_chunks)
    want = JA._flash_decode_core(*(jnp.asarray(x) for x in (q, k, v)),
                                 scale=0.25, kv_len=jnp.int32(kv_len),
                                 n_chunks=n_chunks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    blocked = A._blocked_core(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True, scale=0.25, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), blocked.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_flash_decode_defers_to_the_blocked_core_where_the_reference_does():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    blocked = A._blocked_core(q, k, v, causal=True, scale=0.25, kv_len=37)
    for n in (1, 3):                    # one chunk; 64 % 3 != 0
        got = A._flash_decode_core(q, k, v, scale=0.25, kv_len=37, n_chunks=n)
        assert torch.equal(got, blocked)
    # no mesh and no n_chunks: one chunk
    assert torch.equal(A.attention_core(q, k, v, causal=True, scale=0.25,
                                        impl="flash_decode", kv_len=37),
                       blocked)
    # Sq > 1 needs the causal mask within a block
    q2 = torch.randn(B, HQ, 3, D, generator=torch.Generator().manual_seed(1))
    assert torch.equal(
        A._flash_decode_core(q2, k, v, scale=0.25, kv_len=40, n_chunks=4),
        A._blocked_core(q2, k, v, causal=True, scale=0.25, kv_len=40))


@pytest.mark.parametrize("world,data", [(2, 1), (4, 1), (4, 2)])
def test_sharded_combine_under_gloo_matches_one_process(world, data,
                                                        tmp_path):
    """Each rank holds its chunk of the keys; the partials meet in one
    max and one sum over ``model``.  At kv_len 1 every rank but the first
    holds only keys beyond it and contributes w = 0."""
    q, k, v = _qkv(3)
    kv_lens = (64, 37, 1)
    got = run_ranks(flash_decode_worker, world, tmp_path, q, k, v, kv_lens,
                    data)
    for i, kv_len in enumerate(kv_lens):
        want = A._flash_decode_core(*(torch.from_numpy(x) for x in (q, k, v)),
                                    scale=0.25, kv_len=kv_len,
                                    n_chunks=world // data).numpy()
        for start, outs in got:
            out = outs[i]
            np.testing.assert_allclose(out, want[start:start + out.shape[0]],
                                       rtol=1e-6, atol=1e-6)


PCFG = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                      remat="none")
JPCFG = JaxPCfg(compute_dtype="float32", kv_cache_dtype="float32",
                remat="none")


@pytest.mark.parametrize("arch", ["radar-lm-100m", "deepseek-v2-lite-16b"])
def test_decode_step_with_flash_decode_matches_the_reference(arch):
    """GQA's decode step and MLA's (the latent expanded over the filled
    positions, then the flash-decode core) against the reference's."""
    jcfg = jax_config(arch).reduced()
    tcfg = get_any_config(arch).reduced()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    tparams = from_reference(tcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    Bq, Sq = 1, 12
    toks = np.array(jax.random.randint(jax.random.key(4), (Bq, Sq + 1), 0,
                                       jcfg.vocab_size))
    jc = JM.init_caches(jcfg, JPCFG, batch=Bq, max_len=Sq + 1)
    _, jc = jprefill(jcfg, JPCFG, jparams, jc, jnp.asarray(toks[:, :Sq]))
    want, _ = jdecode(jcfg, JPCFG, jparams, jc, jnp.asarray(toks[:, Sq:]),
                      jnp.int32(Sq), attn_impl="flash_decode")
    tc = M.init_caches(tcfg, PCFG, Bq, Sq + 1, device="cpu")
    _, tc = tprefill(tcfg, PCFG, tparams, tc, torch.from_numpy(toks[:, :Sq]),
                     attn_impl="blocked")
    got, _ = tdecode(tcfg, PCFG, tparams, tc, torch.from_numpy(toks[:, Sq:]),
                     Sq, attn_impl="flash_decode")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ["radar-lm-100m", "zamba2-1.2b"])
def test_serving_on_a_mesh_of_2_matches_one_process(arch, tmp_path):
    """DTensor parameters and caches (the keys' sequence over ``model``):
    the prefill gathers each layer's cache rows, the flash-decode steps
    reduce each rank's own keys."""
    steps = 4
    got = run_ranks(serve_worker, 2, tmp_path, arch, 0, steps)
    cfg = get_any_config(arch).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    Bq, Sq = 2, 16
    caches = M.init_caches(cfg, PCFG, Bq, Sq + steps, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (Bq, Sq), generator=gen)
    logits, caches = M.decode_step(cfg, PCFG, params, caches, toks, 0)
    want = [logits[:, -1].numpy()]
    nxt = logits[:, -1].argmax(-1)[:, None]
    for i in range(steps):
        logits, caches = M.decode_step(cfg, PCFG, params, caches, nxt, Sq + i,
                                       attn_impl="flash_decode")
        want.append(logits[:, -1].numpy())
        nxt = logits[:, -1].argmax(-1)[:, None]
    for rank_out in got:
        for a, b in zip(rank_out, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq", [1, 5])
def test_kernel_proxy_core_equals_the_reference(sq):
    rng = np.random.default_rng(sq)
    q = rng.normal(size=(2, 8, sq, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 9, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 9, 16)).astype(np.float32)
    got = A._kernel_proxy_core(*(torch.from_numpy(x) for x in (q, k, v)),
                               scale=0.25)
    want = JA._kernel_proxy_core(*(jnp.asarray(x) for x in (q, k, v)),
                                 scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
