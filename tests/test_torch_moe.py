"""The port's mixture-of-experts FFN against the reference package's.

``models.moe.apply_moe`` in its three dispatches (sorted, GShard einsum,
dropless) on the reference's parameters (``repro.models.moe.init_moe``)
and the same inputs, made from numpy seeds: outputs and aux losses at
``tests/test_moe_dispatch.py``'s tolerances, the tight-capacity drop case,
top-1 gates of 1, the dispatch counters, and gradients through the sorted
dispatch.  Reduced ``deepseek-v2-lite-16b`` (top-6 of 64 -> top-2 of 4,
two shared experts) and ``llama4-maverick-400b-a17b`` (top-1, one shared).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

MOE_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_moe_dispatch.py
AUX_RTOL = 1e-5                           # tests/test_moe_dispatch.py
MOE_ARCHS = ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"]


def _normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(tree):
    """A reference pytree (numpy or jax leaves) as torch tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _cfgs(arch, **moe_kw):
    jcfg, tcfg = jax_config(arch).reduced(), get_any_config(arch).reduced()
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe_kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe_kw))
    return jcfg, tcfg


def _moe_case(arch, seed, shape=(4, 64), **moe_kw):
    jcfg, tcfg = _cfgs(arch, **moe_kw)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jcfg, jax.random.key(seed),
                                               jnp.float32))
    x = _normal(seed + 1, *shape, jcfg.d_model)
    return jcfg, tcfg, p, x


def _check_moe(jcfg, tcfg, p, x, **kw):
    want, jaux = jmoe.apply_moe(jcfg, p, jnp.asarray(x), **kw)
    got, aux = moe.apply_moe(tcfg, _t(p), torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    assert set(aux) == set(jaux) == {"moe_load_balance", "moe_z_loss"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=AUX_RTOL)
    return got


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("kw", [dict(dispatch="sorted"),
                                dict(dispatch="einsum"),
                                dict(dropless=True)],
                         ids=["sorted", "einsum", "dropless"])
def test_apply_moe_matches_reference(arch, kw):
    _check_moe(*_moe_case(arch, 7), **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_dispatch_matches_reference_on_random_routing(seed):
    """tests/test_moe_dispatch.py's property, against the reference."""
    _check_moe(*_moe_case("deepseek-v2-lite-16b", 100 + seed, shape=(2, 16)),
               dispatch="sorted")


@pytest.mark.parametrize("dispatch", ["sorted", "einsum"])
def test_tight_capacity_drops_the_reference_assignments(dispatch):
    """cf 0.05: most assignments fall through, the same ones in both
    packages, and the sorted dispatch counts them."""
    jcfg, tcfg, p, x = _moe_case("deepseek-v2-lite-16b", 7,
                                 capacity_factor=0.05)
    moe.dropped = 0
    got = _check_moe(jcfg, tcfg, p, x, dispatch=dispatch)
    assert torch.isfinite(got).all()
    dense, _ = moe.apply_moe(tcfg, _t(p), torch.from_numpy(x), dropless=True)
    assert float((got - dense).abs().max()) > 1e-3
    T, K, E = 4 * 64, tcfg.moe.top_k, tcfg.moe.n_experts
    cap = moe.capacity(tcfg, T)
    assert cap == max(1, int(K * T * 0.05 / E))
    if dispatch == "sorted":
        # each expert keeps its first `cap` assignments
        logits = x.reshape(T, -1) @ p["router"]
        idx = np.argsort(-logits, axis=-1, kind="stable")[:, :K]
        loads = np.bincount(idx.ravel(), minlength=E)
        assert int(moe.dropped) == int(np.maximum(loads - cap, 0).sum()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_top1_gates_are_one(arch):
    """top_k = 1 with ample capacity: the normalized gate is exactly 1, and
    the sorted dispatch equals the dropless one and the reference's."""
    jcfg, tcfg, p, x = _moe_case(arch, 0, shape=(2, 8), top_k=1,
                                 capacity_factor=64.0)
    got = _check_moe(jcfg, tcfg, p, x, dispatch="sorted")
    dense = _check_moe(jcfg, tcfg, p, x, dropless=True)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **MOE_TOL)


def test_moe_dispatch_counts_and_refuses_an_unknown_dispatch():
    _jcfg, tcfg, p, x = _moe_case("deepseek-v2-lite-16b", 3, shape=(1, 4))
    before = dict(moe.dispatches)
    moe.apply_moe(tcfg, _t(p), torch.from_numpy(x))
    moe.apply_moe(tcfg, _t(p), torch.from_numpy(x), dropless=True)
    assert moe.dispatches["sorted"] == before["sorted"] + 1
    assert moe.dispatches["dropless"] == before["dropless"] + 1
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        moe.apply_moe(tcfg, _t(p), torch.from_numpy(x), dispatch="dense")


def test_moe_grads_flow_through_the_sorted_dispatch():
    """The training path differentiates the sorted dispatch: the router
    through the gates, the experts through the gathered tokens."""
    _jcfg, tcfg, p, x = _moe_case("deepseek-v2-lite-16b", 5, shape=(2, 16))
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    y, aux = moe.apply_moe(tcfg, tp, torch.from_numpy(x))
    (y.square().mean() + sum(aux.values())).backward()
    for name, leaf in tp.items():
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
        assert float(leaf.grad.abs().sum()) > 0, name


