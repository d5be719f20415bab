"""MLA's decode step on a sequence-sharded latent cache.

The reference's rules lay the latent cache ``(B, S, kv_lora)`` and the
RoPE-key cache ``(B, S, rope)`` out with the batch on the data axes and
the sequence on ``model`` (on the data axes too for a batch that does not
divide them), and its flash-decode core pins the expanded keys' chunk
dim to ``model``: compiled, each rank expands every head over its own
positions of the latent, and only the softmax partials are all-reduced.
The port's decode step (``attn_impl="flash_decode"``, one token) keeps
``latent`` and ``k_rope`` DTensors (``models.model._local_caches``),
writes the new token into the one shard that holds its position, expands
every head over the shard's filled positions alone
(``attention.mla_shard_partials``) and combines the partials over the
sequence's mesh dims (``attention.combine_shards``).

* Serving deepseek-v2-lite ``.reduced()`` (4 heads) in float32 at
  ``(1, 2)`` and ``(2, 2)`` under gloo, a batch of 1 at ``(2, 2)`` (its
  sequence over data and ``model``): a prefill, a second chunk and 4
  flash-decode steps give one process's logits, and the latent caches
  gathered whole after each chunk and at the end give its caches; with
  a cache whose last shards hold no filled position, one whose decode
  steps land inside a shard, and one whose sequence does not divide
  ``model`` (replicated by the rules: it decodes on the whole latent, as
  before).
* What each rank computed: every head, over the positions of its shard
  below ``kv_len`` and no other (none on an empty shard), the shard
  starting at the rank's own offset; no latent leaf redistributed in a
  decode step.
* Without a group: ``m`` shards' partials combined give the whole
  block's decode token; a shard of no positions gives the neutral
  partial, which changes nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_spawn import (CHUNK, DECODES, PREFILL,  # noqa: E402
                          chunked_config, expert_parallel_worker, run_ranks,
                          serve_chunks)
from repro_torch.models import attention  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
# the logits within 1e-5 of each value and of the largest one's magnitude
# (tests/test_torch_attention_parallel.py); the latent caches within 1e-6
# the same way: the later layers' inputs carry the rounding of the
# prefill's sums over ``model`` (its MLA heads' and experts' partial
# outputs), 2.7e-6 apart on values up to 4.1; the first layer's, whose
# input no sum touched, within 1e-6 of each value (bit for bit at one
# data rank; a data rank's rows are a matmul of fewer rows)
LOGIT_RTOL = 1e-5
CACHE_RTOL = 1e-6
FIRST_TOL = dict(rtol=1e-6, atol=1e-6)
# (mesh, batch, max_len): the decode steps write positions 12 to 15
CASES = (
    ("1x2", 2, 16),     # shards of 8, both filled
    ("1x2", 2, 24),     # shards of 12: the steps land inside rank 1's
    ("1x2", 2, 40),     # shards of 20: rank 1 holds no filled position
    ("1x2", 2, 17),     # 17 does not divide 2: replicated, decoded whole
    ("2x2", 2, 16),     # the batch over data, the sequence over model
    ("2x2", 1, 16),     # a batch of 1: the sequence over data and model
    ("2x2", 1, 64),     # shards of 16: three ranks hold none filled
)
IDS = [f"{m}-b{b}-len{n}" for m, b, n in CASES]
WORLD = {"1x2": 2, "2x2": 4}
MODEL = 2
HEADS = 4                               # the reduced configuration's


def _sharded(batch, max_len, world):
    """Whether the rules shard the latent's sequence (over ``model``, and
    over the data axis too for a batch that does not divide it)."""
    data = world // MODEL
    return max_len % (MODEL * (data if batch % data else 1)) == 0


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """{(mesh, batch, max_len): [(result, what the blocks computed) per
    rank]}: one gloo run a mesh, every case of it a job."""
    out = {}
    for name, world in WORLD.items():
        cases = [c for c in CASES if c[0] == name]
        ranks = run_ranks(expert_parallel_worker, world,
                          tmp_path_factory.mktemp(f"mla{world}"),
                          [("chunks", ARCH, None, n, b, MODEL)
                           for _m, b, n in cases])
        for i, case in enumerate(cases):
            out[case] = [jobs[i] for jobs in ranks]
    return out


_ONE = {}


def _one_process(batch, max_len):
    if (batch, max_len) not in _ONE:
        _ONE[batch, max_len] = serve_chunks(chunked_config(ARCH), batch,
                                            max_len)
    return _ONE[batch, max_len]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_serving_matches_one_process(meshed, case):
    _mesh, batch, max_len = case
    _row0, want_logits, want_caches = _one_process(batch, max_len)
    assert len(want_logits) == 2 + DECODES
    for (row0, logits, caches), _seen in meshed[case]:
        for got, want in zip(logits, want_logits):
            np.testing.assert_allclose(
                got, want[row0:row0 + got.shape[0]], rtol=LOGIT_RTOL,
                atol=LOGIT_RTOL * float(np.abs(want).max()))
        assert len(caches) == len(want_caches) == 3
        for got_step, want_step in zip(caches, want_caches):
            for got_g, want_g in zip(got_step, want_step):
                for got_c, want_c in zip(got_g, want_g):
                    assert set(got_c) == set(want_c) == {"latent", "k_rope"}
                    for k in got_c:
                        np.testing.assert_allclose(
                            got_c[k], want_c[k], rtol=CACHE_RTOL,
                            atol=CACHE_RTOL * float(np.abs(want_c[k]).max()),
                            err_msg=k)
            for k in ("latent", "k_rope"):
                np.testing.assert_allclose(got_step[0][0][k][0],
                                           want_step[0][0][k][0],
                                           **FIRST_TOL, err_msg=k)


def _shard_of(rank, world, batch, max_len):
    """(first position, positions) of rank ``rank``'s latent shard."""
    data = world // MODEL
    if batch % data:                    # the sequence over data and model
        n = max_len // world
        return rank * n, n
    n = max_len // MODEL
    return (rank % MODEL) * n, n


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_each_rank_expands_every_head_over_its_own_positions(meshed, case):
    mesh, batch, max_len = case
    world = WORLD[mesh]
    first = PREFILL + CHUNK            # the first decode step's position
    for rank, ((_r, _l, _c), seen) in enumerate(meshed[case]):
        # the prefill chunks expand the rank's 2 heads over the filled
        # latent, gathered whole
        whole = {e for e in seen["mla_expanded"] if len(e) == 2}
        shards = seen["mla_expanded"] - whole
        if not _sharded(batch, max_len, world):
            assert whole == {(2, PREFILL), (2, PREFILL + CHUNK)} | {
                (HEADS, first + i + 1) for i in range(DECODES)}
            assert shards == set()
            assert seen["mla_heads"] == {(2, True), (HEADS, False)}
            continue
        assert whole == {(2, PREFILL), (2, PREFILL + CHUNK)}, rank
        offset, n = _shard_of(rank, world, batch, max_len)
        assert shards == {
            (HEADS, max(0, min(n, first + i + 1 - offset)), offset, n,
             first + i + 1) for i in range(DECODES)}, rank
        assert seen["mla_heads"] == {(2, True), (HEADS, False, n, max_len)}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_no_latent_leaf_is_redistributed_in_a_decode_step(meshed, case):
    """The decode steps redistribute parameters alone; the prefill
    chunks gather each sequence-sharded latent leaf's rows (the record
    sees them).  A replicated sequence is the rank's rows as stored,
    redistributed by neither."""
    mesh, batch, max_len = case
    cfg = chunked_config(ARCH)
    leaves = {(batch, max_len, cfg.mla.kv_lora_rank),
              (batch, max_len, cfg.mla.qk_rope_head_dim)}
    for (_r, _l, _c), seen in meshed[case]:
        moved = seen["redistributed"]
        assert {s for s, tokens in moved if tokens == 1} & leaves == set()
        in_prefill = {s for s, tokens in moved if tokens == PREFILL}
        if _sharded(batch, max_len, WORLD[mesh]):
            assert leaves <= in_prefill
        else:
            assert in_prefill & leaves == set()


# -- the shards in one process, with no group ---------------------------------

def _block(seed=0, batch=2, max_len=24, fill=20):
    """A reduced MLA block's parameters (float32), a latent cache whose
    first ``fill`` positions a prefill wrote, and the next token's
    input and position."""
    cfg = chunked_config(ARCH)
    gen = torch.Generator().manual_seed(seed)
    p = {k: v.detach() for k, v in attention.init_mla(
        cfg, gen, torch.float32, "cpu").items()}
    cache = attention.init_mla_cache(cfg, batch, max_len, torch.float32,
                                     "cpu")
    x = torch.randn((batch, fill + 1, cfg.d_model), generator=gen)
    pos = torch.arange(fill + 1).expand(batch, fill + 1)
    with torch.no_grad():
        attention.apply_mla(cfg, p, x[:, :fill], pos[:, :fill], cache=cache,
                            cache_index=0)
    return cfg, p, cache, x[:, fill:], pos[:, fill:]


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("fill", [3, 20])
def test_shards_combined_give_the_whole_decode_token(m, fill):
    """``m`` shards of a 24-position cache, each rank's partials from its
    own positions, concatenated and combined, against the whole block's
    decode token; at ``fill`` 3 most shards hold no filled position."""
    cfg, p, cache, x, pos = _block(fill=fill)
    whole_cache = {k: c.clone() for k, c in cache.items()}
    with torch.no_grad():
        want, _ = attention.apply_mla(cfg, p, x, pos, cache=whole_cache,
                                      cache_index=fill, impl="flash_decode")
        q, latent, k_rope = attention.mla_project(cfg, p, x, pos)
        cache["latent"][:, fill:fill + 1] = latent
        cache["k_rope"][:, fill:fill + 1] = k_rope
        n = cache["latent"].shape[1] // m
        parts = [attention.mla_shard_partials(
            cfg, p, q, cache["latent"][:, r * n:(r + 1) * n],
            cache["k_rope"][:, r * n:(r + 1) * n], offset=r * n,
            kv_len=fill + 1) for r in range(m)]
        o = attention.combine_shards([torch.cat(t, dim=3)
                                      for t in zip(*parts)])
        B = x.shape[0]
        got = o.transpose(1, 2).reshape(B, 1, -1) @ p["wo"]
    for k in cache:
        assert torch.equal(cache[k], whole_cache[k])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_an_empty_shard_gives_the_neutral_partial():
    cfg, p, cache, x, pos = _block(fill=20)
    with torch.no_grad():
        q, _l, _k = attention.mla_project(cfg, p, x, pos)
        empty = attention.mla_shard_partials(
            cfg, p, q, cache["latent"][:, 21:], cache["k_rope"][:, 21:],
            offset=21, kv_len=21)
        m_c, l_c, o_c = empty
        assert torch.all(m_c == attention.NEG_INF)
        assert torch.all(l_c == 0) and torch.all(o_c == 0)
        full = attention.mla_shard_partials(
            cfg, p, q, cache["latent"][:, :21], cache["k_rope"][:, :21],
            offset=0, kv_len=21)
        alone = attention.combine_shards(full)
        both = attention.combine_shards([torch.cat(t, dim=3)
                                         for t in zip(full, empty)])
    assert torch.isfinite(both).all()
    assert torch.equal(alone, both)
