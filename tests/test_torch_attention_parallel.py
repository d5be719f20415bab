"""GQA attention heads on the ``model`` axis in a serving prefill.

The reference's rules shard the columns of ``wq``, ``wk`` and ``wv`` and
the rows of ``wo`` over ``model`` in whole heads, and lay a KV cache out
as ``(B, Hkv, S, dh)`` with the batch on the data axes and the sequence
on ``model``.  A prefill computes each rank's Hq/m and Hkv/m heads
(``distributed.sharding.gather_for_compute``); the rank's heads of each
stored cache are moved to it by an all-to-all over ``model`` (a narrow
where the rules replicate the sequence) and back after the block
(``sharding.kv_heads_local``).  A decode step computes every head on the
sequence-sharded flash-decode core, as before.

* Serving at ``(1, 2)`` and ``(2, 2)`` under gloo, zamba2-1.2b's shared
  block and stablelm-3b (4 query and 4 KV heads) and llama3.2-1b with 2
  KV heads (a group of 2), ``.reduced()``, float32: a prefill, a second
  chunk at ``cache_index > 0`` and 4 flash-decode steps give one
  process's logits, and the caches gathered whole after each chunk and
  at the end give its caches; with ``max_len`` 20 (the sequence sharded
  over ``model``) and 21 (replicated), and with a batch of 1 at ``(2,
  2)`` (the sequence over the data axes too).
* What each rank computed: ``wq`` ``(D, Hq/m·dh)`` and ``wo`` ``(Hq/m·dh,
  D)`` in a prefill, whole in a decode step.
* The prefill chunks on the ``kernel`` and ``flash_decode`` cores too.
* Plain ``.reduced()`` llama3.2-1b (1 KV head) does not divide ``model``:
  its block computes whole, as one process does.
* A cache whose heads start filled with distinct constants keeps them in
  place, at the positions the prefill did not write, after a
  heads-local prefill at world 2.
* A GQA block's ``m`` shards (``sharding.model_shard``) at m = 2 and 4,
  each writing its heads of one cache with no process group: their
  partial outputs sum to the whole block's, and the cache they fill is
  the whole block's, in a prefill and a decode step after it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_spawn import (DECODES, FILLED_START, PREFILL,  # noqa: E402
                          CHUNK, chunked_config, expert_parallel_worker,
                          run_ranks, serve_chunks)
from repro_torch.distributed.sharding import model_shard  # noqa: E402
from repro_torch.models import attention  # noqa: E402

# (arch, n_kv_heads override): 4 query heads each, 4, 4 and 2 KV heads
ARCHS = (("zamba2-1.2b", None), ("stablelm-3b", None), ("llama3.2-1b", 2))
IDS = ["zamba2-1.2b", "stablelm-3b", "llama3.2-1b-kv2"]
# the logits: within 1e-5 of each value and of the largest one's
# magnitude.  llama3.2-1b's reach 17, and at a model axis of 2 they are
# 2e-5 apart from one process's in the layout that computes its
# attention whole too (its MLP's sum over ``model``)
LOGIT_RTOL = 1e-5
# the caches: every layer's input after the first carries the rounding of
# the sums over ``model`` before it (the MLP's and now attention's
# all-reduce), 3.8e-6 apart on values near 1 in the layout that computes
# attention whole too, so the whole caches within 1e-5; where the first layer
# is an attention layer, its keys and values, whose input no sum over
# ``model`` touched, within 1e-6 (a data rank's rows are a matmul of
# fewer rows, a few float32 steps apart)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
FIRST_TOL = dict(rtol=1e-6, atol=1e-6)
BATCH = 2
MAX_LENS = (20, 21)                 # 20 divides a model axis of 2, 21 not
PREFILL_IMPLS = ("kernel", "flash_decode")


def _jobs(model):
    """The serving runs of one world: every arch at both lengths, and at
    ``(2, 2)`` a batch of 1 (its sequence over the data axis too)."""
    jobs = [("chunks", arch, kv, n, BATCH, 2)
            for arch, kv in ARCHS for n in MAX_LENS]
    if model == "2x2":
        jobs += [("chunks", "llama3.2-1b", 2, 20, 1, 2)]
    else:
        # 1 KV head (no group divides 2), a cache of distinct heads, and
        # the prefill chunks on the kernel route's and the flash-decode
        # core's plain versions
        jobs += [("chunks", "llama3.2-1b", None, 20, BATCH, 2),
                 ("chunks", "stablelm-3b", None, 20, BATCH, 2, True)]
        jobs += [("chunks", "llama3.2-1b", 2, n, BATCH, 2, False, impl)
                 for impl in PREFILL_IMPLS for n in MAX_LENS]
    return jobs


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """{mesh: [[(result, what the blocks computed) per job] per rank]}:
    ``"1x2"`` at world 2, ``"2x2"`` at world 4."""
    return {name: run_ranks(expert_parallel_worker, world,
                            tmp_path_factory.mktemp(f"attn{world}"),
                            _jobs(name))
            for name, world in (("1x2", 2), ("2x2", 4))}


_ONE = {}


def _one_process(arch, kv, max_len, batch, fill=False,
                 prefill_impl="blocked"):
    key = (arch, kv, max_len, batch, fill, prefill_impl)
    if key not in _ONE:
        _ONE[key] = serve_chunks(chunked_config(arch, kv), batch, max_len,
                                 fill=fill, prefill_impl=prefill_impl)
    return _ONE[key]


def _check_run(ranks, job):
    """Each rank's logits and the gathered caches against one process."""
    _name, arch, kv, max_len, batch, _model, *more = job
    _row0, want_logits, want_caches = _one_process(arch, kv, max_len, batch,
                                                   *more)
    assert len(want_logits) == 2 + DECODES
    for (row0, logits, caches), _seen in ranks:
        for got, want in zip(logits, want_logits):
            rows = want[row0:row0 + got.shape[0]]
            np.testing.assert_allclose(
                got, rows, rtol=LOGIT_RTOL,
                atol=LOGIT_RTOL * float(np.abs(want).max()))
        for got_step, want_step in zip(caches, want_caches):
            for got_g, want_g in zip(got_step, want_step):
                for got_c, want_c in zip(got_g, want_g):
                    assert set(got_c) == set(want_c)
                    for k in got_c:
                        np.testing.assert_allclose(got_c[k], want_c[k],
                                                   **CACHE_TOL, err_msg=k)
    # the first layer's keys and values, after each step
    if "k" not in want_caches[0][0][0]:
        return
    for (_r, _l, caches), _seen in ranks:
        for got_step, want_step in zip(caches, want_caches):
            for k in ("k", "v"):
                np.testing.assert_allclose(got_step[0][0][k][0],
                                           want_step[0][0][k][0],
                                           **FIRST_TOL, err_msg=k)


@pytest.mark.parametrize("max_len", MAX_LENS)
@pytest.mark.parametrize("arch,kv", ARCHS, ids=IDS)
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_heads_local_serving_matches_one_process(meshed, mesh, arch, kv,
                                                 max_len):
    jobs = _jobs(mesh)
    i = jobs.index(("chunks", arch, kv, max_len, BATCH, 2))
    _check_run([rank_jobs[i] for rank_jobs in meshed[mesh]], jobs[i])


@pytest.mark.parametrize("max_len", MAX_LENS)
@pytest.mark.parametrize("impl", PREFILL_IMPLS)
def test_heads_local_prefill_on_each_core_matches_one_process(meshed, impl,
                                                              max_len):
    """The prefill chunks on ``kernel`` (its plain version here) and on
    ``flash_decode``, each on the rank's plain heads-local cache."""
    jobs = _jobs("1x2")
    job = ("chunks", "llama3.2-1b", 2, max_len, BATCH, 2, False, impl)
    _check_run([rank_jobs[jobs.index(job)] for rank_jobs in meshed["1x2"]],
               job)


def test_a_batch_of_one_shards_the_sequence_over_every_axis(meshed):
    """At ``(2, 2)`` a batch of 1 does not divide the data axis: the rules
    put the cache's sequence over ``data`` and ``model``, and the rank's
    heads are gathered over ``data`` first."""
    jobs = _jobs("2x2")
    i = jobs.index(("chunks", "llama3.2-1b", 2, 20, 1, 2))
    _check_run([rank_jobs[i] for rank_jobs in meshed["2x2"]], jobs[i])


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch,kv", ARCHS, ids=IDS)
def test_each_rank_computes_its_heads_in_a_prefill(meshed, mesh, arch, kv):
    cfg = chunked_config(arch, kv)
    D, dh, H = cfg.d_model, cfg.head_dim, cfg.n_heads
    jobs = _jobs(mesh)
    for n in MAX_LENS:
        i = jobs.index(("chunks", arch, kv, n, BATCH, 2))
        for rank_jobs in meshed[mesh]:
            seen = rank_jobs[i][1]["attn_weights"]
            assert seen == {((D, H // 2 * dh), (H // 2 * dh, D), True),
                            ((D, H * dh), (H * dh, D), False)}


def test_heads_that_do_not_divide_model_compute_whole(meshed):
    cfg = chunked_config("llama3.2-1b")
    assert cfg.n_kv_heads == 1
    D, H = cfg.d_model, cfg.n_heads * cfg.head_dim
    jobs = _jobs("1x2")
    i = jobs.index(("chunks", "llama3.2-1b", None, 20, BATCH, 2))
    ranks = [rank_jobs[i] for rank_jobs in meshed["1x2"]]
    _check_run(ranks, jobs[i])
    for _res, seen in ranks:
        assert seen["attn_weights"] == {((D, H), (H, D), True),
                                        ((D, H), (H, D), False)}


def test_each_head_stays_in_place(meshed):
    """The cache starts with head ``h`` filled with ``h + 1`` (``k``) and
    ``-(h + 1)`` (``v``); the prefill writes positions from
    ``FILLED_START`` on.  After a heads-local prefill at world 2 every
    position before it and after the last written still holds its head's
    constant, on every layer, and the rest is one process's."""
    jobs = _jobs("1x2")
    job = ("chunks", "stablelm-3b", None, 20, BATCH, 2, True)
    i = jobs.index(job)
    ranks = [rank_jobs[i] for rank_jobs in meshed["1x2"]]
    _check_run(ranks, job)
    cfg = chunked_config("stablelm-3b")
    heads = np.arange(1, cfg.n_kv_heads + 1, dtype=np.float32)
    written = FILLED_START + PREFILL + CHUNK + DECODES
    for (_row0, _logits, caches), _seen in ranks:
        for step, end in ((0, FILLED_START + PREFILL),
                          (1, FILLED_START + PREFILL + CHUNK),
                          (2, written)):
            for group in caches[step]:
                for c in group:
                    for k, sign in (("k", 1), ("v", -1)):
                        want = sign * heads[None, None, :, None, None]
                        for part in (c[k][:, :, :, :FILLED_START],
                                     c[k][:, :, :, end:]):
                            assert np.array_equal(
                                part, np.broadcast_to(want, part.shape)), k


# -- the shards of one block, each writing its heads of one cache --------------

SHARD_CASES = [(arch, kv, m) for arch, kv in ARCHS for m in (2, 4)
               if chunked_config(arch, kv).n_kv_heads % m == 0]
SHARD_IDS = [f"{IDS[ARCHS.index((a, kv))]}-m{m}" for a, kv, m in SHARD_CASES]
SHARD_BATCH, SHARD_PROMPT, SHARD_LEN = 2, 12, 16


@pytest.mark.parametrize("impl", ["blocked", "kernel"])
@pytest.mark.parametrize("arch,kv,m", SHARD_CASES, ids=SHARD_IDS)
def test_gqa_shards_sum_to_the_whole_block_and_fill_its_cache(arch, kv, m,
                                                              impl):
    """The CPU counterpart of the chip smoke's model-axis GQA phase: rank
    ``r``'s shard writes its heads ``[r·n, (r+1)·n)`` of one cache over a
    prefill, then one decode token on the filled cache; the partial
    outputs sum to the whole block's (within 1e-5) and the cache equals
    the whole block's."""
    cfg = chunked_config(arch, kv)
    gen = torch.Generator().manual_seed(3)
    p = {k: v.detach() for k, v in attention.init_attn(
        cfg, gen, torch.float32, "cpu").items()}
    B, S = SHARD_BATCH, SHARD_PROMPT
    x = torch.randn((B, S + 1, cfg.d_model), generator=gen)
    pos = torch.arange(S + 1).expand(B, S + 1)

    def block(params, cache):
        return [attention.apply_attn(cfg, params, x[:, :S], pos[:, :S],
                                     cache=cache, cache_index=0,
                                     impl=impl)[0],
                attention.apply_attn(cfg, params, x[:, S:], pos[:, S:],
                                     cache=cache, cache_index=S,
                                     impl=impl)[0]]

    want_cache = attention.init_kv_cache(cfg, B, SHARD_LEN, torch.float32,
                                         "cpu")
    want = block(p, want_cache)
    cache = attention.init_kv_cache(cfg, B, SHARD_LEN, torch.float32, "cpu")
    n = cfg.n_kv_heads // m
    sums = [torch.zeros_like(o) for o in want]
    for r in range(m):
        shard = model_shard(p, r, m)
        assert shard["wq"].shape[-1] == cfg.n_heads // m * cfg.head_dim
        assert shard["wk"].shape[-1] == n * cfg.head_dim
        heads = {k: c[:, r * n:(r + 1) * n] for k, c in cache.items()}
        for acc, o in zip(sums, block(shard, heads)):
            acc.add_(o)
    for got, ref in zip(sums, want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for k in ("k", "v"):
        assert torch.equal(cache[k], want_cache[k]), k
