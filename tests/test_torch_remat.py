"""Rematerialization in the port against the reference package.

``ParallelConfig.remat`` picks what a layer keeps for its backward pass:
``"none"`` every activation, ``"block"`` its input alone, ``"dots"`` also
the outputs of the matrix products with no batch dims (the reference's
``dots_with_no_batch_dims_saveable``, here a selective-checkpoint policy,
``models.model.remat_call``).  The values are the same under each: for
radar-lm-100m and deepseek-v2-lite-16b (reduced, float32) the loss and
every gradient under ``"dots"`` equal ``"block"`` and ``"none"``, and the
reference's ``value_and_grad`` under its ``"dots"``.  What differs is the
backward pass's work and the memory: under ``"dots"`` it re-runs none of
the saved ``aten.mm`` and fewer ops than under ``"block"``, and the dry
run's probes (``launch.costing.probe_cell``) keep fewer bytes
than ``"none"`` and more than ``"block"``.  An unknown policy raises, and
``launch.train --remat dots`` trains.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_any_config as jget  # noqa: E402
from repro.configs.base import ParallelConfig as JPCFG  # noqa: E402
from repro.data.batches import make_batch as jmake_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_any_config, get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import (from_reference,  # noqa: E402
                                        to_reference, unstack)
from repro_torch.train.tree import leaves, tree_map  # noqa: E402

ARCHS = ("radar-lm-100m", "deepseek-v2-lite-16b")
REMATS = ("none", "block", "dots")
# tests/test_torch_train.py's float32 tolerance against the reference
F32_TOL = dict(rtol=1e-4, atol=1e-6)


class OpCounter(TorchDispatchMode):
    """Counts each aten op dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    """(arch, the reference's parameters, the port's in the stacked
    layout, the batch in each package)."""
    arch = request.param
    jcfg, cfg = jget(arch).reduced(), get_any_config(arch).reduced()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    params = to_reference(from_reference(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    return (arch, jcfg, cfg, jparams, params,
            jmake_batch(jcfg, 2, 32, seed=7),
            make_batch(cfg, 2, 32, seed=7, device="cpu"))


def _port_grads(cfg, params, batch, remat, counter=None):
    """(loss, gradients in the reference's leaf order) of the port's
    training loss under ``remat``; ``counter`` on over the backward pass
    alone."""
    pcfg = ParallelConfig(compute_dtype="float32", remat=remat)
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = M.train_loss(cfg, pcfg, unstack(ps), batch,
                           slstm_cost_proxy=True)
    if counter is None:
        grads = torch.autograd.grad(loss, leaves(ps))
    else:
        with counter:
            grads = torch.autograd.grad(loss, leaves(ps))
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def port_runs(arch_setup):
    _arch, _jcfg, cfg, _jp, params, _jb, batch = arch_setup
    return {r: _port_grads(cfg, params, batch, r) for r in REMATS}


@pytest.mark.parametrize("remat", ["none", "block"])
def test_dots_gives_the_same_loss_and_gradients(port_runs, remat):
    loss, grads = port_runs["dots"]
    want_loss, want = port_runs[remat]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_dots_equals_the_references_dots(arch_setup, port_runs):
    _arch, jcfg, _cfg, jparams, _p, jbatch, _b = arch_setup
    jpcfg = JPCFG(compute_dtype="float32", remat="dots")
    (jloss, _m), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, jpcfg, p, jbatch, attn_impl="blocked",
                             slstm_cost_proxy=True), has_aux=True)(jparams)
    loss, grads = port_runs["dots"]
    np.testing.assert_allclose(loss, float(jloss), **F32_TOL)
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a, np.asarray(b), **F32_TOL)


def test_dots_backward_reruns_no_saved_matmul(arch_setup):
    """The backward pass's ops: ``"block"`` re-runs the forward's ``mm``s
    beside the gradient's own; ``"dots"`` runs only the gradient's (as
    ``"none"`` does) and fewer ops than ``"block"`` in all."""
    _arch, _jcfg, cfg, _jp, params, _jb, batch = arch_setup
    counts = {}
    for remat in REMATS:
        counter = OpCounter()
        _port_grads(cfg, params, batch, remat, counter)
        counts[remat] = counter.ops
    mm = torch.ops.aten.mm.default
    assert counts["block"][mm] > counts["none"][mm]
    assert counts["dots"][mm] == counts["none"][mm]
    assert sum(counts["dots"].values()) < sum(counts["block"].values())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b"])
def test_probed_kept_bytes_under_dots_lie_between(arch):
    """A train cell's probes on a fake group of one: each layer group's
    repeat unit keeps fewer bytes for its backward pass under ``"dots"``
    than under ``"none"``, and more than under ``"block"`` (its input
    alone, which the probe does not allocate); the FLOPs likewise, as
    ``"dots"`` recomputes less than ``"block"``."""
    from repro_torch.launch import costing, dryrun
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("train_cut", 64, 2, "train")
    live, flops = {}, {}
    with dryrun.fake_group(1):
        mesh = make_host_mesh(1, device_type="cpu")
        for remat in REMATS:
            pcfg = ParallelConfig(remat=remat)
            total, _parts, live[remat] = costing.probe_cell(
                cfg, pcfg, mesh, shape)
            flops[remat] = total.flops
    assert live["block"]["stored"] < live["dots"]["stored"] \
        < live["none"]["stored"]
    for g in live["none"]["kept"]:
        assert live["block"]["kept"][g] < live["dots"]["kept"][g] \
            < live["none"]["kept"][g], g
    assert flops["none"] < flops["dots"] < flops["block"]


def test_an_unknown_remat_raises(arch_setup):
    _arch, _jcfg, cfg, _jp, params, _jb, batch = arch_setup
    with pytest.raises(ValueError, match="unknown remat 'layers'"):
        _port_grads(cfg, params, batch, "layers")
    with pytest.raises(ValueError, match="unknown remat"):
        M.remat_call("full", lambda x: x, torch.ones(1))


def test_train_command_line_takes_remat():
    """``launch.train --remat`` on the CPU: the same losses under each
    policy."""
    from repro_torch.launch import train
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--steps", "2", "--warmup", "1", "--log-every", "1"]
    losses = {r: train.main(argv + ["--remat", r])["losses"]
              for r in REMATS}
    for r in ("block", "dots"):
        for s in (1, 2):
            np.testing.assert_allclose(losses[r][s], losses["none"][s],
                                       rtol=1e-6)
    with pytest.raises(SystemExit):
        train.main(argv + ["--remat", "layers"])
