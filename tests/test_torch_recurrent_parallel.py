"""Mamba-2 and mLSTM heads on the ``model`` axis.

The reference's rules shard Mamba-2's fused ``w_in`` and ``conv`` by
columns and the mLSTM's ``w_up``, ``w_gates`` and ``conv`` by columns,
its per-head ``w_q``/``w_k``/``w_v`` by heads and its ``w_down`` by rows;
the port computes each block on the rank's H/m heads
(``distributed.sharding.gather_for_compute``: the fused leaves gathered
whole and narrowed to the rank's heads, their gradients ``Partial`` over
``model``).  The gated norm's sum of squares and the mLSTM's gate
pre-activations are summed over ``model`` forward and backward
(``layers.sum_over_model``), one ``reduce_from_model`` sums the block's
output, and a prefill all-gathers its new state's heads
(``layers.write_heads``) into the caches, which stay replicated over
``model`` as the reference lays them out.

* ``launch.train --model-axis 2`` at world 2 and at world 4 (two data
  ranks) under gloo, zamba2-1.2b (16 Mamba-2 heads) and xlstm-1.3b (4
  mLSTM heads) at ``.reduced()`` size: losses and parameters after 3
  steps within the mesh tests' tolerances of one process.
* Serving on a ``(1, 2)`` mesh: a prefill of 16 and 4 decode steps give
  one process's logits and, after the prefill, its caches.
* zamba2's one-step loss at ``(1, 2)`` against the reference on two host
  devices (``tests/_reference_mesh.py``).
* At ``--model-axis 3`` neither arch's heads divide ``model``: both
  blocks compute whole on every rank, as one process does.
* What each rank computed: H/m heads in training and in a prefill, every
  head in a decode step; ``_tp_block`` recognizes both blocks, not where
  H does not divide ``model``.
* A block's ``m`` shards (``sharding.model_shard``): combined in process
  (Mamba-2: the sums of squares first, the outputs after) and through a
  gloo group of 2 (both blocks, with a state), they give the whole block.
* ``launch.mesh.make_host_mesh`` without ``device_type`` raises where
  there is no GPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _reference_mesh import reference_mesh_losses  # noqa: E402
from _torch_spawn import (expert_parallel_worker, run_ranks,  # noqa: E402
                          with_adam_eps)
from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.distributed.sharding import model_shard  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm, xlstm  # noqa: E402
from repro_torch.models.layers import rms_project  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

ARCHS = ("zamba2-1.2b", "xlstm-1.3b")
ARGS = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--warmup", "2", "--log-every", "1", "--steps", "3"]
STEPS = 4
PCFG = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                      remat="none")
TOL = dict(rtol=1e-4, atol=1e-5)   # test_torch_mesh_train._check_mesh_of_2
# AdamW's eps for both runs.  Its update lr · g / (|g| + eps) moves by up
# to lr / eps per unit of g: at the default 1e-8 that is 3e4, and zamba2's
# w_in holds elements whose first gradient is 7.6e-9 (the rest of their
# row: 2.5e-3 on average), whose float32 rounding (a few 1e-9 between the
# two layouts' sums) then moved a parameter by 2.5e-5 after 3 steps.  At
# 1e-6 a gradient's rounding moves its parameter by at most 300 times it.
ADAM_EPS = 1e-6
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
# the caches after a prefill, as the logits: a layer's input carries the
# rounding of the sums over ``model`` before it (1.2e-6 seen in zamba2's
# conv windows, of values near 1)
CACHE_TOL = LOGIT_TOL
REF_CASE = ("zamba2-1.2b", 4, 32, 1)
REF_LOSS_ATOL = 1e-5               # test_torch_mesh_train.MESH_LOSS_ATOL
BLOCK_BATCH, BLOCK_SEQ = 2, 24
# the reduced configurations' heads: zamba2 d_inner 256 / P 16, xlstm 4
HEADS = {"zamba2-1.2b": 16, "xlstm-1.3b": 4}
SEEN = {"zamba2-1.2b": "ssm_heads", "xlstm-1.3b": "mlstm_heads"}


def _train_argv(arch, model):
    return ARGS + ["--arch", arch, "--model-axis", str(model)]


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """{world: [(result, what the blocks computed) per job] per rank}:
    world 2 trains both archs at ``--model-axis 2``, serves them on a
    ``(1, 2)`` mesh, computes each arch's first recurrent block as two
    shards and takes zamba2's reference step; world 3 trains and serves
    them at ``--model-axis 3``; world 4 trains them at ``--model-axis
    2``."""
    trees = {REF_CASE[0]: jax.tree.map(np.asarray, JM.init_params(
        jax_config(REF_CASE[0]).reduced(), jax.random.key(0)))}
    out = {}
    for world, model in ((2, 2), (3, 3), (4, 2)):
        jobs = [("train", _train_argv(a, model), ADAM_EPS) for a in ARCHS]
        if world < 4:
            jobs += [("serve", a, 0, STEPS, True) for a in ARCHS]
        if world == 2:
            jobs += [("block", a, 1, BLOCK_BATCH, BLOCK_SEQ) for a in ARCHS]
            jobs += [("step", [REF_CASE], trees, 2)]
        out[world] = run_ranks(expert_parallel_worker, world,
                               tmp_path_factory.mktemp(f"rec{world}"), jobs)
    return out


@pytest.fixture(scope="module")
def one_process():
    """{arch: (losses, parameters)} of the same steps with no mesh."""
    from repro_torch.launch import train
    out = {}
    for arch in ARCHS:
        with with_adam_eps(train, ADAM_EPS):
            rec = train.main(ARGS + ["--arch", arch])
        out[arch] = (rec["losses"], {p: t.numpy() for p, t in
                                     leaves_with_paths(rec["state"].params)})
    return out


def _check_training(losses, params, want_losses, want_params):
    assert sorted(losses) == [1, 2, 3]
    for s in losses:
        np.testing.assert_allclose(losses[s], want_losses[s], rtol=1e-4)
    assert set(params) == set(want_params)
    for p, a in params.items():
        np.testing.assert_allclose(a, want_params[p], **TOL, err_msg=p)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_training_at_model_axis_2_matches_one_process(meshed, one_process,
                                                      world, arch):
    (losses, params), _seen = meshed[world][0][ARCHS.index(arch)]
    _check_training(losses, params, *one_process[arch])


_SERVED = {}


def _serve_one_process(arch):
    """One process's logits of a prefill and ``STEPS`` greedy steps, and
    its caches after the prefill (as :func:`serve_worker` makes them)."""
    if arch in _SERVED:
        return _SERVED[arch]
    cfg = get_any_config(arch).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    B, S = 2, 16
    caches = M.init_caches(cfg, PCFG, B, S + STEPS, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    logits, caches = M.decode_step(cfg, PCFG, params, caches, toks, 0)
    after = [[{k: c.clone().numpy() for k, c in d.items()} for d in group]
             for group in caches]
    out = [logits[:, -1].numpy()]
    nxt = logits[:, -1].argmax(-1)[:, None]
    for i in range(STEPS):
        logits, caches = M.decode_step(cfg, PCFG, params, caches, nxt, S + i,
                                       attn_impl="flash_decode")
        out.append(logits[:, -1].numpy())
        nxt = logits[:, -1].argmax(-1)[:, None]
    _SERVED[arch] = out, after
    return _SERVED[arch]


def _check_serving(got, want):
    (logits, caches), (want_logits, want_caches) = got, want
    assert len(logits) == len(want_logits) == STEPS + 1
    for a, b in zip(logits, want_logits):
        np.testing.assert_allclose(a, b, **LOGIT_TOL)
    assert len(caches) == len(want_caches)
    for group, want_group in zip(caches, want_caches):
        for d, want_d in zip(group, want_group):
            assert set(d) == set(want_d)
            for k in d:
                np.testing.assert_allclose(d[k], want_d[k], **CACHE_TOL,
                                           err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_a_mesh_of_2_matches_one_process(meshed, arch):
    """A heads-local prefill's states all-gathered over ``model``: every
    rank's caches after it are one process's, and the decode steps, which
    compute every head, give its logits."""
    want = _serve_one_process(arch)
    for rank_jobs in meshed[2]:
        got, _seen = rank_jobs[len(ARCHS) + ARCHS.index(arch)]
        _check_serving(got, want)


def test_zamba2_at_model_axis_2_gives_the_references_loss(meshed):
    """zamba2-1.2b's step on a ``(data, model) = (1, 2)`` mesh: the port
    computes each rank's 8 of the 16 Mamba-2 heads, the reference lays
    the same weights out by its rules on two host devices; one step's
    ``loss_total`` agrees within ``REF_LOSS_ATOL`` on both ranks."""
    want, = reference_mesh_losses([REF_CASE], data=1, model=2)
    for rank, rank_jobs in enumerate(meshed[2]):
        (loss,), _seen = rank_jobs[-1]
        assert abs(loss - want) <= REF_LOSS_ATOL, (rank, loss, want)


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_computes_its_heads(meshed, world):
    """At ``--model-axis 2`` a rank computes 8 of zamba2's 16 Mamba-2
    heads and 2 of xlstm's 4 mLSTM heads in every training call and
    every prefill, and every head in a decode step."""
    for rank_jobs in meshed[world]:
        for arch, (_res, seen) in zip(ARCHS, rank_jobs):
            assert seen[SEEN[arch]] == {(HEADS[arch] // 2, True)}, seen
        for arch, (_res, seen) in zip(ARCHS, rank_jobs[len(ARCHS):
                                                       2 * len(ARCHS)]):
            assert seen[SEEN[arch]] == {(HEADS[arch] // 2, True),
                                        (HEADS[arch], False)}, seen


@pytest.mark.parametrize("arch", ARCHS)
def test_heads_that_do_not_divide_model_compute_whole(meshed, one_process,
                                                      arch):
    """At ``--model-axis 3`` zamba2's 16 and xlstm's 4 heads do not
    divide ``model``: every rank computes every head, in training and in
    serving, as one process does."""
    i = ARCHS.index(arch)
    for rank, rank_jobs in enumerate(meshed[3]):
        train_res, train_seen = rank_jobs[i]
        served, serve_seen = rank_jobs[len(ARCHS) + i]
        if rank == 0:
            _check_training(*train_res, *one_process[arch])
        assert train_seen[SEEN[arch]] == {(HEADS[arch], True)}
        assert serve_seen[SEEN[arch]] == {(HEADS[arch], True),
                                          (HEADS[arch], False)}
        _check_serving(served, _serve_one_process(arch))


# -- the blocks on a fake group: what is kept and what gathered ---------------

def _recurrent_layer(params, key):
    for group in params["groups"]:
        for layer in group[0].values():
            if key in layer["mixer"]:
                return layer["mixer"]
    raise AssertionError(f"no mixer holds {key}")


def _on_a_fake_mesh(cfg, m, fn):
    """``fn(mixer)`` for the first Mamba-2 or mLSTM mixer of the
    reference tree's meta tensors laid out by the rules on a ``(data,
    model) = (1, m)`` mesh over a fake process group."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.sharding import distribute, param_shardings
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.models.convert import unstack
    ref = M.param_specs(cfg)
    with fake_group(m):
        mesh = init_device_mesh("cpu", (1, m),
                                mesh_dim_names=("data", "model"))
        params = unstack(distribute(ref, param_shardings(
            cfg, PCFG, ref, mesh), mesh))
        key = "w_in" if cfg.ssm is not None else "w_q"
        return fn(_recurrent_layer(params, key))


@pytest.mark.parametrize("m,tp", [(2, True), (4, True), (3, False)])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_block_recognizes_the_recurrent_blocks(arch, m, tp):
    from repro_torch.distributed.sharding import _tp_block
    cfg = get_any_config(arch).reduced()
    assert _on_a_fake_mesh(cfg, m, lambda mixer: _tp_block(cfg, mixer)) == tp


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_for_compute_keeps_the_ranks_heads(arch):
    """At ``(1, 2)`` each leaf is the rank's heads' share; with
    ``heads=False`` (a decode step) every leaf is whole."""
    from repro_torch.distributed.sharding import gather_for_compute
    cfg = get_any_config(arch).reduced()
    D = cfg.d_model

    def shapes(mixer):
        tp = gather_for_compute(cfg, {"mixer": mixer})["mixer"]
        whole = gather_for_compute(cfg, {"mixer": mixer}, heads=False)
        return ({k: tuple(v.shape) for k, v in tp.items()},
                {k: tuple(v.shape) for k, v in whole["mixer"].items()},
                {k: tuple(v.shape) for k, v in mixer.items()})
    local, whole, stored = _on_a_fake_mesh(cfg, 2, shapes)
    assert whole == stored
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * D
        H, N = d_inner // s.head_dim, s.d_state
        w, hl = d_inner // 2, H // 2
        assert local["w_in"] == (D, 2 * w + 2 * N + hl)
        assert local["conv"] == (s.conv_width, w + 2 * N)
        assert local["A_log"] == local["D"] == local["dt_bias"] == (hl,)
        assert local["norm_scale"] == (w,)
        assert local["w_out"] == (w, D)
    else:
        H = cfg.n_heads
        d_inner = int(cfg.xlstm.mlstm_proj_factor * D)
        dh, w = d_inner // H, d_inner // 2
        assert local["w_up"] == (D, 2 * w)
        assert local["conv"] == (cfg.xlstm.conv_width, w)
        assert local["w_q"] == local["w_k"] == local["w_v"] == (H // 2, dh,
                                                                  dh)
        assert local["w_gates"] == (w, 2 * H)
        assert local["gate_bias"] == (H,)
        assert local["norm_scale"] == (w,)
        assert local["w_down"] == (w, D)


# -- the shards of one block, combined ----------------------------------------

def _block(arch, seed):
    """(cfg, the arch's Mamba-2 or mLSTM parameters from ``seed``, the
    block's input (BLOCK_BATCH, BLOCK_SEQ, D)), as ``block_worker`` makes
    them."""
    cfg = get_any_config(arch).reduced()
    gen = torch.Generator().manual_seed(seed)
    init = ssm.init_mamba2 if cfg.ssm is not None else xlstm.init_mlstm
    p = {k: v.detach() for k, v in init(cfg, gen, torch.float32,
                                        "cpu").items()}
    x = torch.randn((BLOCK_BATCH, BLOCK_SEQ, cfg.d_model), generator=gen)
    return cfg, p, x


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("m", [2, 4])
def test_mamba2_shards_combine_to_the_whole_block(m, with_state):
    """zamba2-1.2b reduced: each of ``m`` ranks' shards runs
    ``ssm.mamba2_mix`` in turn with no group; their sums of squares are
    summed, then their ``layers.rms_project`` outputs: the whole block's
    output.  With a state each rank's own copy holds its heads' new state
    (with no group a shard writes its heads alone), and those are the
    whole block's."""
    cfg, p, x = _block("zamba2-1.2b", 2)
    d_inner = ssm._dims(cfg)[1]

    def state():
        return ssm.init_mamba2_state(cfg, BLOCK_BATCH, "cpu") \
            if with_state else None
    whole_state = state()
    want, _ = ssm.apply_mamba2(cfg, p, x, state=whole_state)
    parts = []
    for r in range(m):
        shard, own = model_shard(p, r, m), state()
        hl = shard["A_log"].shape[0]
        yf, sq, _ = ssm.mamba2_mix(cfg, shard, x, state=own,
                                   head_offset=r * hl)
        parts.append((shard, yf, sq))
        if with_state:
            heads = slice(r * hl, (r + 1) * hl)
            np.testing.assert_allclose(own["ssm"][:, heads],
                                       whole_state["ssm"][:, heads],
                                       rtol=1e-6, atol=1e-6)
            cols = slice(r * d_inner // m, (r + 1) * d_inner // m)
            for c in (cols, slice(d_inner, None)):
                np.testing.assert_allclose(own["conv"][..., c],
                                           whole_state["conv"][..., c])
    sq = sum(s for _sh, _y, s in parts)
    got = sum(rms_project(yf, sq, d_inner, sh["norm_scale"], sh["w_out"],
                          x.dtype) for sh, yf, _s in parts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_shards_on_a_model_group_give_the_whole_block(meshed, arch):
    """Each arch's block as two shards on a gloo group of 2, through the
    block's own collectives: with no state and as a prefill from a
    zeroed state, both ranks hold the whole block's output and its whole
    new state."""
    cfg, p, x = _block(arch, 1)
    if cfg.ssm is not None:
        apply, state = ssm.apply_mamba2, ssm.init_mamba2_state(
            cfg, BLOCK_BATCH, "cpu")
    else:
        apply, state = xlstm.apply_mlstm, xlstm.init_mlstm_state(
            cfg, BLOCK_BATCH, "cpu")
    want, _ = apply(cfg, p, x)
    want_state, _ = apply(cfg, p, x, state=state)
    i = 2 * len(ARCHS) + ARCHS.index(arch)
    for rank_jobs in meshed[2]:
        (y, y_state, got_state), seen = rank_jobs[i]
        assert seen[SEEN[arch]] == {(HEADS[arch] // 2, True)}
        np.testing.assert_allclose(y, want.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y_state, want_state.numpy(), rtol=1e-5,
                                   atol=1e-5)
        for k, v in got_state.items():
            np.testing.assert_allclose(v, state[k].numpy(), **CACHE_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("arch,m", [("zamba2-1.2b", 3), ("xlstm-1.3b", 8)])
def test_model_shard_refuses_heads_that_do_not_divide(arch, m):
    cfg, p, _x = _block(arch, 0)
    with pytest.raises(ValueError, match="do not divide a model axis"):
        model_shard(p, 0, m)


def test_make_host_mesh_without_device_type_raises_without_a_gpu(tmp_path):
    """Under a gloo group of one on a host with no GPU, ``make_host_mesh``
    and ``make_production_mesh`` default to ``"cuda"`` and raise rather
    than build a CPU mesh; ``device_type="cpu"`` builds one."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="needs a GPU"):
            make_host_mesh(1)
        with pytest.raises(RuntimeError, match="needs a GPU"):
            make_production_mesh()
        mesh = make_host_mesh(1, device_type="cpu")
        assert mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()
