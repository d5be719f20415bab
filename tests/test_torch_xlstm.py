"""The port's xLSTM mixers against the reference package's.

``models.xlstm``: the chunked mLSTM at lengths that are not a multiple of
the chunk, the mLSTM and sLSTM recurrences from a nonzero state (outputs
and the states they update in place), both mixers without a state, the
recurrence continuing the chunked form, and sLSTM's cost proxy; on the
reference's parameters (reduced ``xlstm-1.3b``) and the same inputs, made
from numpy seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-5)          # a mixer against the reference


def _normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(tree):
    """A reference pytree (numpy or jax leaves) as torch tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _cfgs(arch):
    return jax_config(arch).reduced(), get_any_config(arch).reduced()


@pytest.mark.parametrize("L, chunk", [(45, 16), (32, 32), (7, 16)])
def test_mlstm_chunked_matches_reference(L, chunk):
    B, H, dh = 2, 3, 8
    q, k, v = (_normal(s, B, L, H, dh) for s in (1, 2, 3))
    log_f = -np.abs(_normal(4, B, L, H, scale=0.3))
    log_i = -np.abs(_normal(5, B, L, H))
    want = jxlstm._mlstm_chunked(*map(jnp.asarray, (q, k, v, log_f, log_i)),
                                 chunk)
    got = xlstm._mlstm_chunked(*map(torch.from_numpy,
                                    (q, k, v, log_f, log_i)), chunk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _xlstm_case(kind, seed):
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    init = {"mlstm": jxlstm.init_mlstm, "slstm": jxlstm.init_slstm}[kind]
    p = jax.tree.map(np.asarray, init(jcfg, jax.random.key(seed),
                                      jnp.float32))
    return jcfg, tcfg, p


def _nonzero_state(kind, tcfg, batch, seed):
    init = {"mlstm": xlstm.init_mlstm_state,
            "slstm": xlstm.init_slstm_state}[kind]
    zero = init(tcfg, batch, "cpu")
    rng = np.random.default_rng(seed)
    out = {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in zero.items()}
    if kind == "slstm":
        out["n"] = np.abs(out["n"]) + 0.5      # a normalizer is positive
    return out


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_recurrent_mixer_from_a_nonzero_state_matches_reference(kind):
    jcfg, tcfg, p = _xlstm_case(kind, 8)
    B, S = 2, 9
    x = _normal(9, B, S, jcfg.d_model)
    state = _nonzero_state(kind, tcfg, B, 10)
    japply = {"mlstm": jxlstm.apply_mlstm, "slstm": jxlstm.apply_slstm}[kind]
    tapply = {"mlstm": xlstm.apply_mlstm, "slstm": xlstm.apply_slstm}[kind]
    want, jstate = japply(jcfg, p, jnp.asarray(x),
                          state=jax.tree.map(jnp.asarray, state))
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    held = dict(tstate)
    got, tstate = tapply(tcfg, _t(p), torch.from_numpy(x), state=tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert set(tstate) == set(jstate)
    for name in tstate:
        assert tstate[name] is held[name]       # updated in place
        assert tstate[name].dtype == torch.float32
        np.testing.assert_allclose(tstate[name].numpy(),
                                   np.asarray(jstate[name]), **F32)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_without_state_matches_reference(kind):
    jcfg, tcfg, p = _xlstm_case(kind, 11)
    x = _normal(12, 2, 40, jcfg.d_model)
    japply = {"mlstm": jxlstm.apply_mlstm, "slstm": jxlstm.apply_slstm}[kind]
    tapply = {"mlstm": xlstm.apply_mlstm, "slstm": xlstm.apply_slstm}[kind]
    want, _ = japply(jcfg, p, jnp.asarray(x))
    got, st = tapply(tcfg, _t(p), torch.from_numpy(x))
    assert st is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_mlstm_recurrence_continues_the_chunked_form():
    """Token by token from a zero state gives the chunked form's outputs
    (the two mLSTM forms are one function)."""
    _jcfg, tcfg, p = _xlstm_case("mlstm", 13)
    x = torch.from_numpy(_normal(14, 2, 37, tcfg.d_model))
    chunked, _ = xlstm.apply_mlstm(tcfg, _t(p), x)
    state = xlstm.init_mlstm_state(tcfg, 2, "cpu")
    steps = [xlstm.apply_mlstm(tcfg, _t(p), x[:, :20], state=state)[0]]
    steps += [xlstm.apply_mlstm(tcfg, _t(p), x[:, t:t + 1], state=state)[0]
              for t in range(20, 37)]
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(),
                               chunked.numpy(), **F32)


def test_slstm_cost_proxy_matches_reference():
    jcfg, tcfg, p = _xlstm_case("slstm", 15)
    x = _normal(16, 2, 12, jcfg.d_model)
    want, jst = jxlstm.apply_slstm(jcfg, p, jnp.asarray(x), cost_proxy=True)
    got, st = xlstm.apply_slstm(tcfg, _t(p), torch.from_numpy(x),
                                cost_proxy=True)
    assert jst is None and st is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    real, _ = xlstm.apply_slstm(tcfg, _t(p), torch.from_numpy(x))
    assert float((got - real).abs().max()) > 1e-3     # a stand-in only


