"""Expert parallelism and MLA heads on the ``model`` axis.

The reference's rules shard the MoE expert stacks over ``model`` (the
expert dim) and MLA's per-head projections in whole heads (``wq``,
``w_uk``, ``w_uv`` by columns, ``wo`` by rows); the port computes them as
laid out: each rank runs its E/m experts and H/m heads, and one
``reduce_from_model`` sums the partial outputs
(``distributed.sharding.gather_for_compute``, ``models.moe.apply_moe``,
``models.attention.apply_mla``).

* ``launch.train --model-axis 2`` at world 2 and at world 4 (two data
  ranks) under gloo, deepseek-v2-lite (MLA, 4 experts top-2, shared
  experts) and llama4-maverick (4 experts top-1, one KV head) at
  ``.reduced()`` size: losses and parameters after 3 steps within the
  mesh tests' tolerances of one process, at a capacity factor at which
  nothing drops.  The router and ``w_dkv`` are whole on every rank but
  feed only its experts or heads, so their gradients are partial sums
  over ``model`` (``copy_to_model`` all-reduces them): the parameters pin
  that.
* Serving on a mesh of 2: a prefill and 4 flash-decode steps give one
  process's logits.
* Blocks whose experts or heads do not divide ``model`` (both archs'
  4 experts and 4 heads at ``--model-axis 3``) are replicated by the
  rules and compute whole on every rank, from expert 0, in training and
  in serving, as one process does.
* What each rank computes: E/m experts in every MoE call and capacity
  buffer, H/m heads in a prefill's and a training step's MLA, every head
  in a decode step's, over the rank's positions of the latent cache.
* ``_tp_block`` recognizes both blocks, and not where E or H does not
  divide ``model``; ``gather_for_compute`` keeps the rank's shard and
  gathers the router and ``w_dkv`` whole.
* A block's ``m`` shards (``sharding.model_shard``), computed in turn
  with no process group and summed, give the whole block, and every
  shard drops the assignments the whole block drops.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_spawn import (expert_parallel_worker, run_ranks,  # noqa: E402
                          with_capacity)
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.distributed.sharding import model_shard  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

ARCHS = ("deepseek-v2-lite-16b", "llama4-maverick-400b-a17b")
ARGS = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--warmup", "2", "--log-every", "1", "--steps", "3",
        "--model-axis", "2"]
# C = int(K·T·cf / E) >= T·K with cf = E (4): no expert can overflow, so
# nothing drops, however each data shard routes
CAPACITY = 4.0
STEPS = 4
PCFG = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                      remat="none")
TOL = dict(rtol=1e-4, atol=1e-5)   # test_torch_mesh_train._check_mesh_of_2


def _train_argv(arch, model=2):
    return ARGS[:-1] + [str(model), "--arch", arch]


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """{world: [(result, what the blocks computed) per job] per rank}:
    worlds 2 and 3 train both archs at ``--model-axis`` 2 and 3 and serve
    them on a ``(1, world)`` mesh; world 4 trains them at ``--model-axis
    2``."""
    out = {}
    for world, serve in ((2, True), (3, True), (4, False)):
        jobs = [("train", _train_argv(a, 3 if world == 3 else 2))
                for a in ARCHS]
        if serve:
            jobs += [("serve", a, 0, STEPS) for a in ARCHS]
        ranks = run_ranks(expert_parallel_worker, world,
                          tmp_path_factory.mktemp(f"ep{world}"), jobs,
                          CAPACITY)
        out[world] = ranks
    return out


@pytest.fixture(scope="module")
def one_process():
    """{arch: (losses, parameters)} of the same steps with no mesh."""
    from repro_torch.launch import train
    out = {}
    for arch in ARCHS:
        with with_capacity(train, CAPACITY):
            rec = train.main(ARGS[:-2] + ["--arch", arch])
        out[arch] = (rec["losses"], {p: t.numpy() for p, t in
                                     leaves_with_paths(rec["state"].params)})
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_training_at_model_axis_2_matches_one_process(meshed, one_process,
                                                      world, arch):
    (losses, params), _seen = meshed[world][0][ARCHS.index(arch)]
    _check_training(losses, params, *one_process[arch])


def _check_training(losses, params, want_losses, want_params):
    assert sorted(losses) == [1, 2, 3]
    for s in losses:
        np.testing.assert_allclose(losses[s], want_losses[s], rtol=1e-4)
    assert set(params) == set(want_params)
    for p, a in params.items():
        np.testing.assert_allclose(a, want_params[p], **TOL, err_msg=p)


def _serve_one_process(arch):
    cfg = get_any_config(arch).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    B, S = 2, 16
    caches = M.init_caches(cfg, PCFG, B, S + STEPS, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    logits, caches = M.decode_step(cfg, PCFG, params, caches, toks, 0)
    out = [logits[:, -1].numpy()]
    nxt = logits[:, -1].argmax(-1)[:, None]
    for i in range(STEPS):
        logits, caches = M.decode_step(cfg, PCFG, params, caches, nxt, S + i,
                                       attn_impl="flash_decode")
        out.append(logits[:, -1].numpy())
        nxt = logits[:, -1].argmax(-1)[:, None]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_a_mesh_of_2_matches_one_process(meshed, arch):
    want = _serve_one_process(arch)
    for rank_jobs in meshed[2]:
        got, _seen = rank_jobs[len(ARCHS) + ARCHS.index(arch)]
        assert len(got) == len(want) == STEPS + 1
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_computes_its_experts_and_heads(meshed, world):
    """At ``--model-axis 2`` the reduced configurations' 4 experts and
    deepseek's 4 MLA heads are 2 a rank: in every MoE call (sorted in
    training, dropless serving a short prompt), every capacity buffer,
    and every MLA call but a decode step's, which computes all 4 over
    the rank's 10 of the latent cache's 20 positions, where they lie."""
    for rank_jobs in meshed[world]:
        for arch, (_res, seen) in zip(ARCHS, rank_jobs):
            assert seen["experts"] == {("sorted", 2)}, (arch, seen)
            assert seen["buffers"] == {2}, (arch, seen)
            want = {(2, True)} if arch.startswith("deepseek") else set()
            assert seen["mla_heads"] == want, (arch, seen)
        for arch, (_res, seen) in zip(ARCHS, rank_jobs[len(ARCHS):
                                                       2 * len(ARCHS)]):
            assert seen["experts"] == {("dropless", 2)}, (arch, seen)
            want = ({(2, True), (4, False, 10, 20)}
                    if arch.startswith("deepseek") else set())
            assert seen["mla_heads"] == want, (arch, seen)


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_that_do_not_divide_model_compute_whole(meshed, one_process,
                                                       arch):
    """At ``--model-axis 3`` the reduced configurations' 4 experts and 4
    heads do not divide ``model``: the rules replicate the stacks and the
    head projections, so every rank computes all of them (its experts
    from expert 0, on ranks 1 and 2 too) and gives one process's
    training steps and serving logits."""
    i = ARCHS.index(arch)
    want_logits = _serve_one_process(arch)
    for rank, rank_jobs in enumerate(meshed[3]):
        (train_res, train_seen) = rank_jobs[i]
        (logits, serve_seen) = rank_jobs[len(ARCHS) + i]
        if rank == 0:
            _check_training(*train_res, *one_process[arch])
        assert train_seen["experts"] == {("sorted", 4)}, train_seen
        assert train_seen["buffers"] == {4}, train_seen
        assert serve_seen["experts"] == {("dropless", 4)}, serve_seen
        mla = arch.startswith("deepseek")
        assert train_seen["mla_heads"] == ({(4, True)} if mla else set())
        assert serve_seen["mla_heads"] == ({(4, True), (4, False)} if mla
                                           else set())
        assert len(logits) == len(want_logits) == STEPS + 1
        for a, b in zip(logits, want_logits):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# -- the blocks on a fake group of 2: what is kept and what gathered ----------

def _layer_on_a_fake_mesh(cfg, fn):
    """``fn(mesh, the MoE layer's parameters)``: the reference tree's
    meta tensors laid out by the rules on a ``(data, model) = (1, 2)``
    mesh over a fake process group, the last group's first layer."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.sharding import distribute, param_shardings
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.models.convert import unstack
    ref = M.param_specs(cfg)
    with fake_group(2):
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        params = unstack(distribute(ref, param_shardings(
            cfg, PCFG, ref, mesh), mesh))
        return fn(mesh, params["groups"][-1][0]["layer_0"])


@pytest.mark.parametrize("override,moe_tp,mla_tp", [
    ({}, True, True),
    ({"n_experts": 3}, False, True),
    ({"n_heads": 3}, True, False),
])
def test_tp_block_recognizes_the_moe_and_mla_blocks(override, moe_tp,
                                                    mla_tp):
    from repro_torch.distributed.sharding import _tp_block
    cfg = get_any_config("deepseek-v2-lite-16b").reduced(
        **{k: v for k, v in override.items() if k == "n_heads"})
    if "n_experts" in override:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=override["n_experts"]))
    got = _layer_on_a_fake_mesh(cfg, lambda mesh, layer: (
        _tp_block(cfg, layer["ffn"]), _tp_block(cfg, layer["mixer"])))
    assert got == (moe_tp, mla_tp)


def test_gather_for_compute_keeps_the_ranks_experts_and_heads():
    from repro_torch.distributed.sharding import gather_for_compute
    cfg = get_any_config("deepseek-v2-lite-16b").reduced()
    m = cfg.mla
    H, E = cfg.n_heads, cfg.moe.n_experts
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim

    def shapes(mesh, layer):
        tp = gather_for_compute(cfg, layer)
        decode = gather_for_compute(cfg, layer, attention=False,
                                    heads=False)
        return ({k: tuple(v.shape) for k, v in tp["mixer"].items()},
                {k: tuple(v.shape) for k, v in tp["ffn"].items()},
                {k: tuple(v.shape) for k, v in decode["mixer"].items()})
    mixer, ffn, whole = _layer_on_a_fake_mesh(cfg, shapes)
    D, r = cfg.d_model, m.kv_lora_rank
    assert mixer["wq"] == (D, H // 2 * qd)
    assert mixer["w_uk"] == (r, H // 2 * m.qk_nope_head_dim)
    assert mixer["w_uv"] == (r, H // 2 * m.v_head_dim)
    assert mixer["wo"] == (H // 2 * m.v_head_dim, D)
    # the rules shard w_dkv's columns too; every head needs all of them
    assert mixer["w_dkv"] == (D, r + m.qk_rope_head_dim)
    assert whole["wq"] == (D, H * qd) and whole["wo"] == (H * m.v_head_dim, D)
    Fe = cfg.moe.d_ff_expert
    assert ffn["w_gate"] == ffn["w_up"] == (E // 2, D, Fe)
    assert ffn["w_down"] == (E // 2, Fe, D)
    assert ffn["router"] == (D, E)
    assert ffn["shared_gate"] == (D, Fe * cfg.moe.n_shared // 2)
    assert ffn["shared_down"] == (Fe * cfg.moe.n_shared // 2, D)


# -- the shards of one block, computed in turn and summed ---------------------

def _moe_params(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: v.detach() for k, v in
            moe.init_moe(cfg, gen, torch.float32, "cpu").items()}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", ["sorted", "einsum", "dropless"])
def test_moe_shards_sum_to_the_whole_block_and_drop_alike(kind, m):
    """deepseek-v2-lite reduced at a tight capacity (0.5): each shard's
    dispatch drops the whole block's assignments, and the shards' partial
    outputs (their experts and shared columns) sum to its output."""
    cfg = get_any_config("deepseek-v2-lite-16b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p = _moe_params(cfg, m)
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    kw = {"dropless": True} if kind == "dropless" else {"dispatch": kind}
    moe.dropped = 0
    want, aux = moe.apply_moe(cfg, p, x, **kw)
    whole_drops = int(moe.dropped)
    if kind == "sorted":
        assert whole_drops > 0
    El = cfg.moe.n_experts // m
    total = torch.zeros_like(want)
    for r in range(m):
        moe.dropped = 0
        shard = model_shard(p, r, m)
        assert shard["w_gate"].shape[0] == El
        y, aux_r = moe.apply_moe(cfg, shard, x, expert_offset=r * El, **kw)
        assert int(moe.dropped) == whole_drops
        for k in aux:
            assert torch.equal(aux_r[k], aux[k]), k
        total = total + y
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["sorted", "einsum", "dropless"])
def test_whole_experts_compute_whole_on_any_model_rank(kind, monkeypatch):
    """Stacks that hold all E experts (a block the rules replicate, or
    parameters gathered whole) start at expert 0 whatever this rank's
    ``model`` coordinate."""
    cfg = get_any_config("deepseek-v2-lite-16b").reduced()
    p = _moe_params(cfg, 5)
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(9))
    kw = {"dropless": True} if kind == "dropless" else {"dispatch": kind}
    want, _ = moe.apply_moe(cfg, p, x, **kw)
    monkeypatch.setattr(moe, "model_rank", lambda: 1)
    got, _ = moe.apply_moe(cfg, p, x, **kw)
    assert torch.equal(got, want)


def test_mla_shards_sum_to_the_whole_block():
    """deepseek-v2-lite reduced, 4 heads: a 12-token prefill into the
    latent cache and one decode token, each on 2 and 4 head shards in
    turn (each shard on its own cache, which holds no heads)."""
    cfg = get_any_config("deepseek-v2-lite-16b").reduced()
    gen = torch.Generator().manual_seed(3)
    p = {k: v.detach() for k, v in
         attention.init_mla(cfg, gen, torch.float32, "cpu").items()}
    B, S = 2, 12
    x = torch.randn((B, S + 1, cfg.d_model), generator=gen)
    pos = torch.arange(S + 1).expand(B, S + 1)

    def run(params):
        cache = attention.init_mla_cache(cfg, B, S + 1, torch.float32, "cpu")
        pre, cache = attention.apply_mla(cfg, params, x[:, :S], pos[:, :S],
                                         cache=cache, cache_index=0)
        dec, cache = attention.apply_mla(cfg, params, x[:, S:], pos[:, S:],
                                         cache=cache, cache_index=S)
        return pre, dec, cache

    want_pre, want_dec, want_cache = run(p)
    for m in (2, 4):
        pre = torch.zeros_like(want_pre)
        dec = torch.zeros_like(want_dec)
        for r in range(m):
            a, b, cache = run(model_shard(p, r, m))
            for k in cache:
                assert torch.equal(cache[k], want_cache[k]), k
            pre, dec = pre + a, dec + b
        np.testing.assert_allclose(pre.numpy(), want_pre.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(dec.numpy(), want_dec.numpy(), rtol=1e-5,
                                   atol=1e-6)
