"""The port's gradient codecs and compressed all-reduce against the
reference's: bitwise.

``encode``/``decode`` (int8, bf16, none) and ``compress_with_feedback``
over a tree of gradients, step after step, give the reference's bits:
``torch.round`` and ``jnp.round`` both round half to even, and the scale
is formed in the same order.  ``compressed_psum`` at world 4 (four gloo
processes) gives the bits of the reference's under ``jax.vmap(...,
axis_name=)``: the int8 payloads are summed as integers, so the order of
the sum cannot matter.  The float codecs' sums are compared bitwise on
inputs whose sums are exact in any order, and within their own rounding on
random ones.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_spawn import compressed_psum_worker, run_ranks  # noqa: E402
from repro.distributed import compression as JC  # noqa: E402
from repro_torch.distributed import compression as C  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "normal": rng.normal(size=(64, 48)).astype(np.float32),
        "wide": (rng.standard_cauchy(size=(333,)) * 1e3).astype(np.float32),
        "tiny": (rng.normal(size=(7, 5, 3)) * 1e-30).astype(np.float32),
        # x / scale lands on .5 exactly: round half to even decides
        "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                         np.float32),
        "zeros": np.zeros((4, 4), np.float32),
    }


@pytest.mark.parametrize("codec", ["int8", "bf16", "none"])
def test_codecs_give_the_reference_bits(codec):
    for seed in range(3):
        for name, x in _arrays(seed).items():
            enc = C.encode(torch.from_numpy(x), codec)
            jenc = JC.encode(jnp.asarray(x), codec)
            if codec == "int8":
                assert np.array_equal(enc["q"].numpy(),
                                      np.asarray(jenc["q"])), name
                assert np.array_equal(enc["scale"].numpy().view(np.uint32),
                                      np.asarray(jenc["scale"])
                                      .view(np.uint32)), name
            elif codec == "bf16":
                assert np.array_equal(
                    enc.view(torch.int16).numpy().view(np.uint16),
                    np.asarray(jenc).view(np.uint16)), name
            dec = C.decode(enc, codec).numpy()
            jdec = np.asarray(JC.decode(jenc, codec))
            assert dec.dtype == jdec.dtype == np.float32
            assert np.array_equal(dec.view(np.uint32), jdec.view(np.uint32)), \
                name


def test_ties_round_half_to_even():
    q = C.quantize_int8(torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5]))["q"]
    assert q.tolist() == [127, 0, 2, 2, -2]


@pytest.mark.parametrize("codec", ["int8", "bf16", "none"])
def test_error_feedback_gives_the_reference_bits_step_after_step(codec):
    grads = [_arrays(s) for s in range(4)]
    res = C.init_error_feedback({k: torch.from_numpy(v)
                                 for k, v in grads[0].items()})
    jres = JC.init_error_feedback({k: jnp.asarray(v)
                                   for k, v in grads[0].items()})
    for g in grads:
        comp, res = C.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, res, codec)
        jcomp, jres = JC.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jres, codec)
        for k in g:
            for a, b in ((comp[k], jcomp[k]), (res[k], jres[k])):
                a = a.numpy()
                b = np.asarray(b)
                assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), k


def _psum_inputs(world, exact):
    rng = np.random.default_rng(7)
    if exact:
        # small integers times a power of two: every partial sum is exact
        return [(rng.integers(-64, 64, size=(37, 11)) * 0.25)
                .astype(np.float32) for _ in range(world)]
    return [rng.normal(size=(37, 11)).astype(np.float32) * (1 + r)
            for r in range(world)]


def _reference_psum(xs, codec):
    return np.asarray(jax.vmap(lambda x: JC.compressed_psum(x, "i", codec),
                               axis_name="i")(jnp.asarray(np.stack(xs))))


@pytest.mark.parametrize("codec", ["int8", "bf16", "none"])
def test_compressed_psum_at_world_4_gives_the_reference_bits(codec,
                                                             tmp_path):
    world = 4
    sets = [_psum_inputs(world, exact) for exact in (True, False)]
    got = run_ranks(compressed_psum_worker, world, tmp_path, sets, codec)
    for i, (exact, xs) in enumerate(zip((True, False), sets)):
        want = _reference_psum(xs, codec)
        # each rank's sum rounded once per addition at most (gloo adds in
        # rank order, XLA in its own): 3 roundings of the codec's width
        ulp = 2.0 ** -8 if codec == "bf16" else 2.0 ** -24
        bound = 3 * ulp * np.sum(np.abs(np.stack(xs)), axis=0)
        for r in range(world):
            g = got[r][i]
            assert g.dtype == np.float32
            if codec == "int8" or exact:
                assert np.array_equal(g.view(np.uint32),
                                      want[r].view(np.uint32)), (r, exact)
            else:
                assert np.all(np.abs(g - want[r]) <= bound), (r, codec)


def test_crosspod_transform_only_where_a_pod_axis_exists():
    assert C.make_crosspod_grad_transform(
        abstract_mesh((32, 8), ("data", "model"))) is None
    pod = abstract_mesh((2, 32, 8), ("pod", "data", "model"))
    assert C.make_crosspod_grad_transform(pod, "none") is None
    fn = C.make_crosspod_grad_transform(pod, "int8")
    x = _arrays(0)["normal"]
    got = fn({"w": torch.from_numpy(x)})["w"].numpy()
    want = np.asarray(JC.decode(JC.encode(jnp.asarray(x), "int8"), "int8"))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    enc = C.encode(torch.from_numpy(x), "int8")
    assert C.wire_bytes(enc, "int8") == x.size + 4
    assert C.wire_bytes(C.encode(torch.from_numpy(x), "bf16"), "bf16") \
        == 2 * x.size


def test_crosspod_transform_through_the_train_steps_grad_hook():
    """The transform in ``make_train_step``'s ``grad_transform`` hook, as
    the reference's: one AdamW step of each on the same parameters and
    batch, the gradients int8-compressed at the pod boundary."""
    from repro import train as jtrain
    from repro.configs import get_any_config as jax_config
    from repro.configs.base import ParallelConfig as JaxPCfg
    from repro.data.batches import make_batch as jmake_batch
    from repro.jaxcompat import abstract_mesh as jabstract_mesh
    from repro.models import model as JM
    from repro_torch.configs import get_any_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data import make_batch
    from repro_torch.models.convert import from_reference, to_reference
    from repro_torch.train import (AdamWConfig, TrainState, make_adamw,
                                   make_train_step)
    from repro_torch.train.tree import leaves

    names, sizes = ("pod", "data", "model"), (2, 32, 8)
    jcfg = jax_config("radar-lm-100m").reduced()
    tcfg = get_any_config("radar-lm-100m").reduced()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    jpcfg, pcfg = (JaxPCfg(compute_dtype="float32"),
                   ParallelConfig(compute_dtype="float32"))
    jocfg = jtrain.AdamWConfig(peak_lr=1e-3, warmup_steps=10,
                               total_steps=100)
    ocfg = AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    jst = jtrain.TrainState(jparams,
                            jtrain.make_adamw(jocfg, jpcfg)[0](jparams))
    params = to_reference(from_reference(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    st = TrainState(params, make_adamw(ocfg, pcfg)[0](params))
    jnew, jm = jtrain.make_train_step(
        jcfg, jocfg, jpcfg, grad_transform=JC.make_crosspod_grad_transform(
            jabstract_mesh(sizes, names), "int8"))(
        jst, jmake_batch(jcfg, 2, 16, seed=4))
    new, m = make_train_step(
        tcfg, ocfg, pcfg, grad_transform=C.make_crosspod_grad_transform(
            abstract_mesh(sizes, names), "int8"))(
        st, make_batch(tcfg, 2, 16, seed=4, device="cpu"))
    for k in ("loss_total", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4)
    for a, b in zip(leaves(new.params), jax.tree.leaves(jnew.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
