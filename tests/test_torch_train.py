"""Training in the port against the reference package.

From the same parameters (the reference's ``init_params`` tree, converted)
and the same batch (``make_batch`` draws the same numbers in both
packages), the port's loss, gradient norm and parameters after one AdamW
step, with float32 and with int8 moments, match ``repro``'s within float32
tolerance; a microbatched step matches the full batch; the checkpoint
behaviours of ``tests/test_train.py`` hold in the port; and a checkpoint
written by either package restores in the other, leaf for leaf.  Last, the
command lines: ``launch.train`` resumes from its checkpoint and
``launch.serve --ckpt`` serves it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_any_config as jget  # noqa: E402
from repro.configs.base import ParallelConfig as JPCFG  # noqa: E402
from repro.data.batches import make_batch as jmake_batch  # noqa: E402
from repro.store import Repository as JRepo  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig, SHAPES  # noqa: E402
from repro_torch.data import input_specs, make_batch  # noqa: E402
from repro_torch.models.convert import (from_reference,  # noqa: E402
                                        to_reference)
from repro_torch.store import ObjectStore, Repository  # noqa: E402
from repro_torch.train import (AdamWConfig, CheckpointManager,  # noqa: E402
                               TensorSpec, TrainState, cosine_schedule,
                               init_train_state, make_adamw, make_train_step,
                               train_state_specs)
from repro_torch.train.tree import (leaves, leaves_with_paths,  # noqa: E402
                                    tree_map)

PCFG = ParallelConfig(compute_dtype="float32")
OCFG = AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
JOCFG = jtrain.AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
# float32 tolerance of the comparisons with the reference: the two
# packages sum the same float32 products in other orders
F32_TOL = dict(rtol=1e-4, atol=1e-6)
# the parameters after a step: Adam moves each weight by about
# lr * g / (|g| + eps), so a gradient component as small as float32 noise
# (|g| near eps = 1e-8, its few bits differing between the two sums) moves
# its weight by another fraction of lr (1e-4 at the first step here): held
# to lr / 10 absolute
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, dtype=np.float32))


def _port_state(cfg, jstate, pcfg):
    """The port's state from the reference's: its parameters converted
    (``from_reference``, then back to the stacked layout), moments zero."""
    np_params = jax.tree.map(np.asarray, jstate.params)
    params = to_reference(from_reference(cfg, np_params, device="cpu"))
    init, _ = make_adamw(OCFG, pcfg)
    return TrainState(params, init(params))


@pytest.fixture(scope="module")
def setup():
    cfg = get_any_config("radar-lm-100m").reduced()
    jcfg = jget("radar-lm-100m").reduced()
    jstate = jtrain.init_train_state(jcfg, JOCFG,
                                     JPCFG(compute_dtype="float32"),
                                     jax.random.key(0))
    return cfg, jcfg, jstate, _port_state(cfg, jstate, PCFG)


def _jpcfg(**kw):
    return JPCFG(compute_dtype="float32", **kw)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_converted_tree_round_trips_and_keeps_the_reference_paths(setup):
    cfg, _jcfg, jstate, state = setup
    jl = jax.tree_util.tree_flatten_with_path(jstate.params)[0]
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in kp) for kp, _ in jl]
    port = leaves_with_paths(state.params)
    assert [p for p, _ in port] == jpaths
    for (_kp, a), (_p, b) in zip(jl, port):
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(_np(b), np.asarray(a))


@pytest.mark.parametrize("seed, batch, seq", [(5, 2, 32), (9, 4, 16)])
def test_make_batch_equals_the_reference(setup, seed, batch, seq):
    cfg, jcfg, _js, _s = setup
    got = make_batch(cfg, batch, seq, seed=seed, device="cpu")
    want = jmake_batch(jcfg, batch, seq, seed=seed)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_one_adamw_step_matches_the_reference(setup, moments):
    cfg, jcfg, jstate, _s = setup
    pcfg = dataclasses.replace(PCFG, opt_moment_dtype=moments)
    jpcfg = _jpcfg(opt_moment_dtype=moments)
    jst = jtrain.TrainState(jstate.params,
                            jtrain.make_adamw(JOCFG, jpcfg)[0](jstate.params))
    state = _port_state(cfg, jstate, pcfg)
    jbatch = jmake_batch(jcfg, 4, 32, seed=5)
    batch = make_batch(cfg, 4, 32, seed=5, device="cpu")
    jnew, jm = jtrain.make_train_step(jcfg, JOCFG, jpcfg)(jst, jbatch)
    new, m = make_train_step(cfg, OCFG, pcfg)(state, batch)
    for k in ("loss_total", "grad_norm", "lr"):
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), **F32_TOL)
    assert int(new.opt.step) == int(jnew.opt.step) == 1
    for a, b in zip(leaves(new.params), jax.tree.leaves(jnew.params)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **STEP_TOL)
    if moments == "float32":
        for a, b in zip(leaves(new.opt.nu), jax.tree.leaves(jnew.opt.nu)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-3,
                                       atol=1e-12)
    else:
        # the stored blocks: the same scales, codes within one step of
        # rounding (a value at a .5 boundary may round either way)
        for a, b in zip(leaves(new.opt.mu), jax.tree.leaves(jnew.opt.mu)):
            if a.dtype == torch.int8:
                assert np.abs(_np(a) - np.asarray(b, np.float32)).max() <= 1
            else:
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                           atol=1e-12)


def test_two_steps_with_int8_moments_track_the_reference(setup):
    cfg, jcfg, jstate, _s = setup
    pcfg = dataclasses.replace(PCFG, opt_moment_dtype="int8")
    jpcfg = _jpcfg(opt_moment_dtype="int8")
    jst = jtrain.TrainState(jstate.params,
                            jtrain.make_adamw(JOCFG, jpcfg)[0](jstate.params))
    state = _port_state(cfg, jstate, pcfg)
    jstep = jtrain.make_train_step(jcfg, JOCFG, jpcfg)
    step = make_train_step(cfg, OCFG, pcfg)
    for seed in (5, 6):
        jst, jm = jstep(jst, jmake_batch(jcfg, 2, 32, seed=seed))
        state, m = step(state, make_batch(cfg, 2, 32, seed=seed,
                                          device="cpu"))
        np.testing.assert_allclose(_np(m["loss_total"]),
                                   np.asarray(jm["loss_total"]), **F32_TOL)
    for a, b in zip(leaves(state.params), jax.tree.leaves(jst.params)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)


def test_cosine_and_constant_schedules_equal_the_reference():
    import jax.numpy as jnp
    from repro.train.optimizer import cosine_schedule as jcos

    ours, theirs = cosine_schedule(3e-4, 20, 200), jcos(3e-4, 20, 200)
    for step in (0, 1, 10, 19, 20, 21, 100, 199, 200, 250):
        np.testing.assert_allclose(
            float(ours(torch.tensor(step, dtype=torch.int32))),
            float(theirs(jnp.int32(step))), rtol=1e-6)


# ---------------------------------------------------------------------------
# the port's mirror of tests/test_train.py
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_math():
    ocfg = AdamWConfig(peak_lr=1e-2, warmup_steps=0, total_steps=10,
                       schedule="constant", weight_decay=0.1,
                       grad_clip_norm=1e9)
    init, update = make_adamw(ocfg, PCFG)
    p = {"w": torch.tensor([[1.0, -2.0]])}
    g = {"w": torch.tensor([[0.5, 0.25]])}
    newp, newstate, _ = update(g, init(p), p)
    mhat, nhat = g["w"].numpy(), g["w"].numpy() ** 2
    want = (p["w"].numpy() * (1 - 1e-2 * 0.1)
            - 1e-2 * mhat / (np.sqrt(nhat) + ocfg.eps))
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-5)
    assert int(newstate.step) == 1


def test_grad_clip_applies():
    ocfg = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10,
                       schedule="constant", grad_clip_norm=1.0)
    init, update = make_adamw(ocfg, PCFG)
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = update(g, init(p), p)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


@pytest.mark.parametrize("step", [0, 7, 20, 100, 195, 200])
def test_cosine_schedule_properties(step):
    lr = cosine_schedule(3e-4, 20, 200, final_frac=0.1)(
        torch.tensor(step, dtype=torch.int32))
    assert 0.0 <= float(lr) <= 3e-4 + 1e-9
    if step >= 195:
        assert float(lr) <= 3e-4 * 0.15


def test_microbatched_step_matches_full_batch(setup):
    cfg, _jcfg, _js, state = setup
    batch = make_batch(cfg, 8, 32, seed=5, device="cpu")
    ns1, m1 = make_train_step(cfg, OCFG, PCFG)(state, batch)
    ns4, m4 = make_train_step(
        cfg, OCFG, dataclasses.replace(PCFG, n_microbatches=4))(state, batch)
    np.testing.assert_allclose(float(m1["loss_total"]),
                               float(m4["loss_total"]), rtol=1e-5)
    for a, b in zip(leaves(ns1.params), leaves(ns4.params)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, OCFG, dataclasses.replace(
            PCFG, n_microbatches=3))(state, batch)


def test_int8_moment_option_trains(setup):
    cfg, _jcfg, _js, _s = setup
    pcfg = dataclasses.replace(PCFG, opt_moment_dtype="int8")
    state = init_train_state(cfg, OCFG, pcfg, seed=1, device="cpu")
    assert torch.int8 in {t.dtype for t in leaves(state.opt.mu)}
    step = make_train_step(cfg, OCFG, pcfg)
    batch = make_batch(cfg, 2, 16, seed=6, device="cpu")
    l0 = None
    for _ in range(8):
        state, m = step(state, batch)     # the same batch: the loss falls
        l0 = l0 or float(m["loss_total"])
    assert float(m["loss_total"]) < l0


def test_grad_transform_sees_the_accumulated_gradients(setup):
    cfg, _jcfg, _js, state = setup
    seen = []

    def zero(grads):
        seen.append(grads)
        return tree_map(lambda g: g * 0.0, grads)

    batch = make_batch(cfg, 2, 16, seed=3, device="cpu")
    new, m = make_train_step(cfg, OCFG, PCFG, grad_transform=zero)(state,
                                                                     batch)
    assert len(seen) == 1 and float(m["grad_norm"]) == 0.0
    # zero gradients: only the weight decay moves the parameters
    for a, b in zip(leaves(new.params), leaves(state.params)):
        want = _np(b) * (1 - float(m["lr"]) * (OCFG.weight_decay
                                                 if b.ndim >= 2 else 0.0))
        np.testing.assert_allclose(_np(a), want, rtol=1e-6, atol=1e-7)


def test_specs_allocate_nothing_and_match_the_state(setup):
    cfg, _jcfg, _js, _s = setup
    specs = train_state_specs(cfg, OCFG, PCFG)
    state = init_train_state(cfg, OCFG, PCFG, device="cpu")
    sp, st = leaves_with_paths(specs), leaves_with_paths(state)
    assert [p for p, _ in sp] == [p for p, _ in st]
    for (_p, spec), (_q, t) in zip(sp, st):
        assert isinstance(spec, TensorSpec)
        assert spec.shape == tuple(t.shape) and spec.dtype == t.dtype
    specs_in = input_specs(cfg, SHAPES["train_4k"])
    assert specs_in["tokens"].shape == (256, 4096)


def test_train_state_needs_the_gpu_unless_cpu_is_asked(setup):
    cfg, _jcfg, _js, _s = setup
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        init_train_state(cfg, OCFG, PCFG)
    with pytest.raises(RuntimeError):
        make_batch(cfg, 2, 8)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture()
def ckpt_repo(tmp_path):
    return Repository.create(ObjectStore(str(tmp_path / "ck")))


def test_checkpoint_roundtrip_bitwise(setup, ckpt_repo):
    cfg, _jcfg, _js, state = setup
    mgr = CheckpointManager(ckpt_repo)
    mgr.save(7, state)
    back = mgr.restore(train_state_specs(cfg, OCFG, PCFG), step=7,
                       device="cpu")
    for a, b in zip(leaves(state), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(back.opt.step) == int(state.opt.step)
    params = mgr.restore(train_state_specs(cfg, OCFG, PCFG).params,
                         device="cpu", subtree="params")
    for a, b in zip(leaves(state.params), leaves(params)):
        assert torch.equal(a, b)


def test_checkpoint_atomicity_on_concurrent_writer(setup, ckpt_repo):
    _cfg, _jcfg, _js, state = setup
    mgr = CheckpointManager(ckpt_repo)
    mgr.save(1, state)
    tx = ckpt_repo.writable_session()
    a = tx.create_array("other/data", shape=(4,), dtype="float32",
                        chunks=(4,))
    a.write_full(np.ones(4, np.float32))
    mgr.save(2, state)                      # racing writer
    tx.commit("other data")                 # rebases (disjoint paths)
    assert mgr.steps() == [1, 2]
    assert ckpt_repo.readonly_session().has_array("other/data")


def test_checkpoint_latest_and_prune(setup, ckpt_repo):
    cfg, _jcfg, _js, state = setup
    mgr = CheckpointManager(ckpt_repo)
    for s in (5, 10, 15):
        mgr.save(s, state)
    assert mgr.latest_step() == 15
    assert mgr.prune(keep_last=1) == [5, 10]
    assert mgr.steps() == [15]
    back = mgr.restore(train_state_specs(cfg, OCFG, PCFG), device="cpu")
    assert int(back.opt.step) == int(state.opt.step)


def test_checkpoint_rollback_to_earlier_step(setup, ckpt_repo):
    _cfg, _jcfg, _js, state = setup
    mgr = CheckpointManager(ckpt_repo)
    mgr.save(5, state)
    mgr.save(10, state)
    mgr.rollback_to(5)
    assert mgr.latest_step() == 5
    assert CheckpointManager(Repository.create(
        ObjectStore(str(ckpt_repo.store.root) + "-empty"))).steps() == []


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_packages(setup, tmp_path, moments,
                                             writer):
    cfg, jcfg, jstate, _s = setup
    pcfg = dataclasses.replace(PCFG, opt_moment_dtype=moments)
    jpcfg = _jpcfg(opt_moment_dtype=moments)
    jst = jtrain.TrainState(jstate.params,
                            jtrain.make_adamw(JOCFG, jpcfg)[0](jstate.params))
    jst, _ = jtrain.make_train_step(jcfg, JOCFG, jpcfg)(
        jst, jmake_batch(jcfg, 2, 16, seed=4))
    state = _port_state(cfg, jstate, pcfg)
    state, _ = make_train_step(cfg, OCFG, pcfg)(
        state, make_batch(cfg, 2, 16, seed=4, device="cpu"))
    path = str(tmp_path / "ck")
    if writer == "port":
        CheckpointManager(Repository.create(ObjectStore(path))).save(
            3, state)
        back = jtrain.CheckpointManager(JRepo.open(path)).restore(
            jtrain.train_state_specs(jcfg, JOCFG, jpcfg))
        pairs = zip(leaves(state), jax.tree.leaves(back))
    else:
        jtrain.CheckpointManager(JRepo.create(path)).save(3, jst)
        back = CheckpointManager(Repository.open(path)).restore(
            train_state_specs(cfg, OCFG, pcfg), device="cpu")
        pairs = zip(jax.tree.leaves(jst), leaves(back))
    for a, b in pairs:
        if isinstance(a, torch.Tensor):
            a, b = (a.view(torch.int16).numpy() if a.dtype == torch.bfloat16
                    else a.numpy()), np.asarray(b)
            if b.dtype.name == "bfloat16":
                b = b.view(np.int16)
        else:
            a = np.asarray(a)
            a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
            b = (b.view(torch.int16).numpy() if b.dtype == torch.bfloat16
                 else b.numpy())
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--warmup", "2", "--log-every", "2"]


def test_train_command_line_resumes_where_it_stopped(tmp_path, capsys):
    from repro_torch.launch import train

    whole = train.main(TRAIN_ARGS + ["--steps", "6"])
    ck = str(tmp_path / "ck")
    first = train.main(TRAIN_ARGS + ["--steps", "6", "--ckpt", ck,
                                     "--ckpt-every", "3"])
    assert CheckpointManager(Repository.open(ck)).steps() == [3, 6]
    CheckpointManager(Repository.open(ck)).rollback_to(3)
    second = train.main(TRAIN_ARGS + ["--steps", "6", "--ckpt", ck,
                                      "--ckpt-every", "3"])
    assert second["start_step"] == 3 and sorted(second["losses"]) == [4, 5, 6]
    for s in range(1, 7):
        np.testing.assert_allclose(first["losses"][s], whole["losses"][s],
                                   rtol=1e-6)
    for s in (4, 5, 6):
        np.testing.assert_allclose(second["losses"][s], whole["losses"][s],
                                   rtol=1e-6)
    assert "resuming from checkpoint step 3" in capsys.readouterr().out
    # a mesh whose model axis does not divide the world (one process here)
    with pytest.raises(ValueError, match="not a multiple of model_axis 2"):
        train.main(TRAIN_ARGS + ["--model-axis", "2"])


def test_train_on_an_archive_then_serve_the_checkpoint(tmp_path):
    from repro_torch import etl
    from repro_torch.launch import serve, train
    from repro_torch.serve import Engine

    raw = ObjectStore(str(tmp_path / "raw"))
    etl.generate_raw_archive(raw, n_scans=4, n_az=36, n_gates=64,
                             n_sweeps=3)
    arch = Repository.create(str(tmp_path / "archive"))
    etl.ingest(raw, arch, workers=2)
    ck = str(tmp_path / "ck")
    run = train.main(TRAIN_ARGS + ["--steps", "3", "--data",
                                   str(tmp_path / "archive"), "--ckpt", ck])
    assert all(np.isfinite(v) for v in run["losses"].values())
    argv = ["--reduced", "--device", "cpu", "--requests", "2",
            "--prompt-len", "8", "--new-tokens", "4", "--max-len", "16"]
    outs = serve.main(argv + ["--ckpt", ck])
    cfg = get_any_config("radar-lm-100m").reduced()
    params = from_reference(cfg, run["state"].params, device="cpu")
    pcfg = ParallelConfig(compute_dtype="float32",
                          kv_cache_dtype="float32", remat="none")
    eng = Engine(cfg, pcfg, params, max_len=16, device="cpu")
    want = eng.generate(serve.make_requests(cfg, 2, 8, 4), seed=1)
    for a, b in zip(outs, want):
        np.testing.assert_array_equal(np.asarray(a.tokens),
                                      np.asarray(b.tokens))
