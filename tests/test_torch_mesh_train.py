"""Training on a mesh: ``launch.train --model-axis`` under gloo against one
process, its checkpoint in both packages, and the step's gradient for a
parameter the loss does not read.

``launch.train --model-axis 2 --reduced`` at world 2 (two gloo processes:
the MLP's hidden dim and the vocabulary tensor-parallel over ``model``,
the state's shards by ``param_shardings``) and ``--model-axis 1`` at
world 2 (the batch's rows over ``data``, also for deepseek-v2-lite's MoE
load-balance loss) stay within 1e-4 (float32) of the same steps in one
process with no mesh.  The checkpoint the world-2
run writes restores in the reference package leaf for leaf, and in the
port at world 1, with no mesh and onto a mesh of one (each rank reading
its own chunks).  A bad ``--model-axis`` raises.  And the fault this
slice found and fixed: the training step's gradient of a parameter the
loss does not read (qwen2-vl's token table: its batches carry
embeddings) is zero, as ``jax.grad`` gives it, where the step raised.

Last, one step on a data mesh of 2 against the reference on two host
devices (a subprocess, ``tests/_reference_mesh.py``), within 1e-5: the
MoE dispatch of a batch whose one row does not divide the data ranks
(the reference sorts each data shard of the tokens alone) and
microbatches cut from the global rows before they are shared out over
the data ranks, as the reference cuts them, for deepseek-v2-lite's MoE
and for a dense model; and one step of deepseek-v2-lite on a model axis
of 2 (its experts and MLA heads split over the two ranks) against the
reference on a ``(1, 2)`` mesh of host devices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _reference_mesh import reference_mesh_losses  # noqa: E402
from _torch_spawn import (gather_rows_worker,  # noqa: E402
                          mesh_step_worker, run_ranks, train_worker,
                          with_capacity)
from repro import train as jtrain  # noqa: E402
from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.configs.base import ParallelConfig as JaxPCfg  # noqa: E402
from repro.data.batches import make_batch as jmake_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.store import Repository as JRepo  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.models.convert import to_reference  # noqa: E402
from repro_torch.store import Repository  # noqa: E402
from repro_torch.train import (AdamWConfig, CheckpointManager,  # noqa: E402
                               TrainState, make_adamw, make_train_step,
                               train_state_specs)
from repro_torch.train.tree import leaves, leaves_with_paths  # noqa: E402

ARGS = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--warmup", "2", "--log-every", "1", "--steps", "3"]


def _one_process(arch, capacity_factor=None):
    from repro_torch.launch import train
    with with_capacity(train, capacity_factor):
        rec = train.main(ARGS + ["--arch", arch])
    return rec["losses"], {p: t.numpy() for p, t in
                           leaves_with_paths(rec["state"].params)}


@pytest.mark.parametrize("arch,model_axis", [("radar-lm-100m", 2),
                                             ("radar-lm-100m", 1),
                                             ("llama3.2-1b", 2)])
def test_train_on_a_mesh_of_2_matches_one_process(arch, model_axis,
                                                  tmp_path):
    _check_mesh_of_2(arch, model_axis, tmp_path)


def test_moe_trains_on_a_data_mesh_of_2_as_in_one_process(tmp_path):
    """deepseek-v2-lite's MoE FFN with the batch's rows over ``data``: the
    load-balance loss is the whole batch's (each rank's expert fractions
    and mean router probabilities averaged over the data axes before
    their product), so the losses and parameters are one process's.  The
    expert capacity is raised so that no assignment drops: under a mesh
    the reference sorts and truncates each data shard alone, so at its
    default capacity its drops, too, differ from one process's."""
    _check_mesh_of_2("deepseek-v2-lite-16b", 1, tmp_path,
                     capacity_factor=2.0)


def _check_mesh_of_2(arch, model_axis, tmp_path, capacity_factor=None):
    ck = str(tmp_path / "ck")
    argv = ARGS + ["--arch", arch, "--model-axis", str(model_axis),
                   "--ckpt", ck, "--ckpt-every", "3"]
    (losses, params), _none = run_ranks(train_worker, 2, tmp_path, argv,
                                        capacity_factor)
    want_losses, want_params = _one_process(arch, capacity_factor)
    assert sorted(losses) == [1, 2, 3]
    for s in losses:
        np.testing.assert_allclose(losses[s], want_losses[s], rtol=1e-4)
    assert set(params) == set(want_params)
    for p, a in params.items():
        np.testing.assert_allclose(a, want_params[p], rtol=1e-4, atol=1e-5,
                                   err_msg=p)

    # the checkpoint of the world-2 run, written by rank 0 gathered whole
    cfg = get_any_config(arch).reduced()
    pcfg = ParallelConfig(compute_dtype="float32")
    ocfg = AdamWConfig(warmup_steps=2, total_steps=3)
    mgr = CheckpointManager(Repository.open(ck))
    assert mgr.steps() == [3]
    back = mgr.restore(train_state_specs(cfg, ocfg, pcfg), device="cpu")
    for p, t in leaves_with_paths(back.params):
        assert np.array_equal(t.numpy(), params[p]), p
    # ... in the reference
    jcfg = jax_config(arch).reduced()
    jpcfg = JaxPCfg(compute_dtype="float32")
    jback = jtrain.CheckpointManager(JRepo.open(ck)).restore(
        jtrain.train_state_specs(jcfg, jtrain.AdamWConfig(), jpcfg))
    got = leaves(back)
    want = jax.tree.leaves(jback)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_checkpoint_reshards_onto_a_mesh_of_one(tmp_path):
    """A world-2 run's checkpoint, rolled back to its step 3 and resumed
    by ``--model-axis 1`` in one process (a group of one the script
    starts and tears down itself): each leaf a DTensor read from its
    chunks, the run going on from step 3 as the uninterrupted one."""
    import torch.distributed as dist
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    # five steps (argparse takes the last --steps), a checkpoint at 3 and 5
    argv = ARGS + ["--steps", "5", "--arch", "radar-lm-100m", "--ckpt", ck,
                   "--ckpt-every", "3"]
    run_ranks(train_worker, 2, tmp_path, argv + ["--model-axis", "2"])
    mgr = CheckpointManager(Repository.open(ck))
    assert mgr.steps() == [3, 5]
    mgr.rollback_to(3)
    whole = train.main(ARGS + ["--steps", "5", "--arch", "radar-lm-100m"])
    resumed = train.main(argv + ["--model-axis", "1"])
    assert not dist.is_initialized()
    assert resumed["start_step"] == 3 and sorted(resumed["losses"]) == [4, 5]
    for s in (4, 5):
        np.testing.assert_allclose(resumed["losses"][s], whole["losses"][s],
                                   rtol=1e-4)
    leaf = resumed["state"].params["final_norm"]["scale"]
    assert type(leaf).__name__ == "DTensor"


def test_model_axis_must_divide_the_world():
    from repro_torch.launch import train
    import torch.distributed as dist
    with pytest.raises(ValueError, match="not a multiple of model_axis 3"):
        train.main(ARGS + ["--model-axis", "3"])
    assert not dist.is_initialized()      # the group it started is gone


def test_unread_parameters_get_a_zero_gradient_as_in_the_reference():
    """qwen2-vl's batches carry embeddings, so its token table is not
    read: the port's step raised there (autograd's unused input); the
    reference's jax.grad gives zeros.  One step of each from the same
    parameters and batch."""
    arch = "qwen2-vl-7b"
    jcfg = jax_config(arch).reduced()
    tcfg = get_any_config(arch).reduced()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    jpcfg = JaxPCfg(compute_dtype="float32")
    pcfg = ParallelConfig(compute_dtype="float32")
    # tests/test_torch_archs_train.py's optimizer and tolerances
    jocfg = jtrain.AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    ocfg = AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    jst = jtrain.TrainState(jparams,
                            jtrain.make_adamw(jocfg, jpcfg)[0](jparams))
    params = to_reference(from_reference(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    st = TrainState(params, make_adamw(ocfg, pcfg)[0](params))
    jnew, jm = jtrain.make_train_step(jcfg, jocfg, jpcfg)(
        jst, jmake_batch(jcfg, 2, 16, seed=3))
    new, m = make_train_step(tcfg, ocfg, pcfg)(
        st, make_batch(tcfg, 2, 16, seed=3, device="cpu"))
    for k in ("loss_total", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4)
    table = new.params["embed"]["tokens"]
    # weight decay alone moves an unread table: p * (1 - lr * wd)
    np.testing.assert_allclose(table.numpy(),
                               np.asarray(jnew.params["embed"]["tokens"]),
                               rtol=1e-6)
    for a, b in zip(leaves(new.params), jax.tree.leaves(jnew.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


# one step on a data mesh of 2 against the reference's on two host
# devices: (arch, batch, seq, n_microbatches).  B = 1 does not divide the
# two data ranks, so the rows are whole on each and the MoE dispatch
# splits the 32 tokens into the reference's two data shards; with two
# microbatches each is cut from the global rows before the ranks share it
MESH_CASES = {
    "moe-one-row": ("deepseek-v2-lite-16b", 1, 32, 1),
    "moe-microbatches-b4": ("deepseek-v2-lite-16b", 4, 32, 2),
    "moe-microbatches-b8": ("deepseek-v2-lite-16b", 8, 32, 2),
    "dense-microbatches-b4": ("radar-lm-100m", 4, 32, 2),
}
# near the two packages' agreement without a mesh (1e-6): the microbatch
# fault moved the loss by 5e-4, inside the mesh tests' rtol of 1e-4
MESH_LOSS_ATOL = 1e-5


@pytest.fixture(scope="module")
def mesh_losses(tmp_path_factory):
    """{case: (the reference's loss, the port's on each of 2 ranks)}: the
    reference in one subprocess, the port in one gloo group of 2, every
    case in turn, from the reference's ``init_params(key(0))``."""
    cases = list(MESH_CASES.values())
    want = reference_mesh_losses(cases)
    trees = {arch: jax.tree.map(np.asarray, JM.init_params(
        jax_config(arch).reduced(), jax.random.key(0)))
        for arch in {c[0] for c in cases}}
    got = run_ranks(mesh_step_worker, 2, tmp_path_factory.mktemp("mesh"),
                    cases, trees)
    return {name: (want[i], [r[i] for r in got])
            for i, name in enumerate(MESH_CASES)}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_a_data_mesh_of_2_gives_the_references_loss(mesh_losses, case):
    want, ranks = mesh_losses[case]
    for rank, got in enumerate(ranks):
        assert abs(got - want) <= MESH_LOSS_ATOL, (case, rank, got, want)


def test_a_model_axis_of_2_gives_the_references_loss(tmp_path):
    """deepseek-v2-lite's step on a ``(data, model) = (1, 2)`` mesh: the
    port computes each rank's 2 of the 4 experts and 2 of the 4 MLA heads
    and sums them over ``model``, the reference lays the same weights out
    by its rules on two host devices; one step's ``loss_total`` agrees
    within ``MESH_LOSS_ATOL`` on both ranks."""
    case = ("deepseek-v2-lite-16b", 4, 32, 1)
    want, = reference_mesh_losses([case], data=1, model=2)
    trees = {case[0]: jax.tree.map(np.asarray, JM.init_params(
        jax_config(case[0]).reduced(), jax.random.key(0)))}
    got = run_ranks(mesh_step_worker, 2, tmp_path, [case], trees, 2)
    for rank, (loss,) in enumerate(got):
        assert abs(loss - want) <= MESH_LOSS_ATOL, (rank, loss, want)


def test_the_moe_step_without_a_mesh_is_unchanged():
    """deepseek-v2-lite at B = 1 with no mesh: one dispatch over the 32
    tokens, as before, within 1e-6 of the reference's loss."""
    arch = "deepseek-v2-lite-16b"
    jcfg, cfg = jax_config(arch).reduced(), get_any_config(arch).reduced()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    jpcfg = JaxPCfg(compute_dtype="float32", remat="none")
    pcfg = ParallelConfig(compute_dtype="float32", remat="none")
    jocfg, ocfg = jtrain.AdamWConfig(), AdamWConfig()
    jst = jtrain.TrainState(jparams,
                            jtrain.make_adamw(jocfg, jpcfg)[0](jparams))
    params = to_reference(from_reference(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    st = TrainState(params, make_adamw(ocfg, pcfg)[0](params))
    _j, jm = jtrain.make_train_step(jcfg, jocfg, jpcfg)(
        jst, jmake_batch(jcfg, 1, 32, seed=1000))
    _p, m = make_train_step(cfg, ocfg, pcfg)(
        st, make_batch(cfg, 1, 32, seed=1000, device="cpu"))
    assert abs(float(m["loss_total"]) - float(jm["loss_total"])) <= 1e-6


def test_gather_rows_over_pod_and_data(tmp_path):
    """The MoE's gather of the data shards' outputs at world 4 on a
    ``(pod, data) = (2, 2)`` mesh: every rank holds the rows in data-rank
    order (pod major, as ``batch_shardings`` splits rows), and each rank's
    rows get the gradient summed over the four ranks, once."""
    rows = 2
    out = run_ranks(gather_rows_worker, 4, tmp_path, rows)
    assert sorted(r for r, _y, _g in out) == [0, 1, 2, 3]
    want = np.repeat(np.arange(4, dtype=np.float32), rows)[:, None] \
        * np.ones((1, 3), np.float32)
    weights = np.arange(want.size, dtype=np.float32).reshape(want.shape)
    for r, y, g in out:
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(g, 4 * weights[r * rows:(r + 1) * rows])


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_drops_add_up_every_shards_dispatch(n_shards):
    """The MoE's drop count where a call splits its tokens into data
    shards (each rank dispatches its own): every shard's assignments past
    its capacity, from the routing alone, as each shard's own sorted
    dispatch counts them."""
    from repro_torch.models import moe
    cfg = get_any_config("deepseek-v2-lite-16b").reduced()
    E, K, D, T = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model, 64
    gen = torch.Generator().manual_seed(n_shards)
    p = moe.init_moe(cfg, gen, torch.float32, "cpu")
    # skewed routing: the low experts take most assignments
    idx = torch.stack([torch.randperm(E, generator=gen)[:K] % (E // 2)
                       for _ in range(T)])
    xt = torch.randn((T, D), generator=gen)
    gates = torch.rand((T, K), generator=gen)
    cap = moe.capacity(cfg, T // n_shards)
    Tl = T // n_shards
    want = sum(int(moe._dispatch_sorted(
        xt[s * Tl:(s + 1) * Tl], gates[s * Tl:(s + 1) * Tl],
        idx[s * Tl:(s + 1) * Tl], p, n_experts=E, cap=cap)[1])
        for s in range(n_shards))
    assert want > 0
    assert int(moe._shard_drops(idx, n_shards, E, cap)) == want
