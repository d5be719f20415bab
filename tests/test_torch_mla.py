"""The port's DeepSeek multi-head latent attention against the reference.

``models.attention.apply_mla`` on the reference's parameters
(``repro.models.attention.init_mla``, reduced ``deepseek-v2-lite-16b``:
q/k width 24, v width 16, so v is zero-padded to the q/k width before the
core) and the same inputs, made from numpy seeds: without a cache on each
core (the reference through its Pallas kernel in interpret mode), and
through the latent cache, a prefill then two one-token steps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.models import attention  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-5)          # a mixer against the reference


def _normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(tree):
    """A reference pytree (numpy or jax leaves) as torch tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _cfgs(arch):
    return jax_config(arch).reduced(), get_any_config(arch).reduced()


def _mla_case(seed):
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    p = jax.tree.map(np.asarray, jattn.init_mla(jcfg, jax.random.key(seed),
                                                jnp.float32))
    return jcfg, tcfg, p


@pytest.mark.parametrize("impl", ["kernel", "blocked", "naive"])
def test_apply_mla_without_a_cache_matches_reference(impl):
    jcfg, tcfg, p = _mla_case(3)
    B, S = 2, 19
    x = _normal(4, B, S, jcfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, jc = jattn.apply_mla(jcfg, p, jnp.asarray(x), jnp.asarray(pos),
                               impl="pallas")
    got, c = attention.apply_mla(tcfg, _t(p), torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()), impl=impl)
    assert jc is None and c is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_apply_mla_through_the_latent_cache_matches_reference():
    """A prefill of 11 tokens, then two one-token steps, into a 24-long
    latent cache: outputs and the cache against the reference's."""
    jcfg, tcfg, p = _mla_case(5)
    m = tcfg.mla
    B, L = 2, 24
    x = _normal(6, B, 13, jcfg.d_model)
    jc = jattn.init_mla_cache(jcfg, B, L, jnp.float32)
    tc = attention.init_mla_cache(tcfg, B, L, torch.float32, "cpu")
    assert tuple(tc["latent"].shape) == (B, L, m.kv_lora_rank)
    assert tuple(tc["k_rope"].shape) == (B, L, m.qk_rope_head_dim)
    assert tc["latent"].shape[-1] + tc["k_rope"].shape[-1] == (
        m.kv_lora_rank + m.qk_rope_head_dim)
    latent = tc["latent"]
    for start, n in ((0, 11), (11, 1), (12, 1)):
        xs = x[:, start:start + n]
        pos = np.broadcast_to(np.arange(start, start + n, dtype=np.int32),
                              (B, n)).copy()
        want, jc = jattn.apply_mla(jcfg, p, jnp.asarray(xs),
                                   jnp.asarray(pos), cache=jc,
                                   cache_index=jnp.int32(start))
        got, tc = attention.apply_mla(tcfg, _t(p), torch.from_numpy(xs),
                                      torch.from_numpy(pos), cache=tc,
                                      cache_index=start, impl="kernel")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert tc["latent"] is latent          # written in place
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32)
    assert torch.all(tc["latent"][:, 13:] == 0)
    with pytest.raises(ValueError, match="cannot take"):
        attention.apply_mla(tcfg, _t(p), torch.from_numpy(x),
                            torch.zeros((B, 13), dtype=torch.int32),
                            cache=tc, cache_index=20)


