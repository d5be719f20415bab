"""The port's radar-token LM against the reference package's, on the CPU.

The reference's parameters (``repro.models.model.init_params``) go
through ``repro_torch.models.convert`` into the port, and the same token
batches, made from a seed with numpy, go through both: the forward pass
and loss (the reference's through its Pallas kernel in interpret mode),
prefill (single shot and chunked) and decode with their caches, and
greedy generation through both engines.  Also: the parameter count at
full width, the radar token batches drawn from one archive by both
packages, the converter's checks, and the serve command line.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.configs.base import ParallelConfig as JaxPCfg  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve.engine import decode as jax_decode  # noqa: E402
from repro.serve.engine import prefill as jax_prefill  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve import Engine, Request, decode, prefill  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)        # tests/test_serve.py:33
PCFG = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                      remat="none")
JPCFG = JaxPCfg(compute_dtype="float32", kv_cache_dtype="float32",
                remat="none")
ARCHS = ["radar-lm-100m", "llama3.2-1b", "qwen1.5-4b", "stablelm-3b"]


def _lm(arch, seed=0):
    jcfg = jax_config(arch).reduced()
    tcfg = get_any_config(arch).reduced()
    jparams = JM.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, from_reference(tcfg, tree, device="cpu")


@pytest.fixture(scope="module")
def radar_lm():
    return _lm("radar-lm-100m")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)
                                                ).astype(np.int32)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    """The reduced dense configs: tied embeddings (llama3.2-1b), qkv bias
    (qwen1.5-4b), layernorm and partial rotary (stablelm-3b)."""
    jcfg, tcfg, jparams, tparams = _lm(arch)
    toks = _tokens(1, 2, 40, tcfg.vocab_size)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = JM.forward(jcfg, JPCFG, jparams, jbatch, attn_impl="pallas")
    jloss, _ = JM.loss_fn(jcfg, JPCFG, jparams, jbatch, attn_impl="pallas")
    for impl in ("kernel", "blocked"):
        got, aux = M.forward(tcfg, PCFG, tparams, batch, attn_impl=impl)
        assert got.dtype == torch.float32 and aux == {}
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        loss, metrics = M.loss_fn(tcfg, PCFG, tparams, batch, attn_impl=impl)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        assert float(metrics["loss"]) == float(loss)


def test_bf16_cast_rule_casts_group_leaves_as_the_reference(radar_lm):
    """The reference casts float32 leaves with ndim > 1 on its stacked
    tree: a group's norm scales are 2-D there and go to bf16; the final
    norm stays float32."""
    _, tcfg, _, tparams = radar_lm
    cp = M.compute_params(tparams, "bfloat16")
    layer = cp["groups"][0][0]["layer_0"]
    assert layer["mixer"]["wq"].dtype == torch.bfloat16
    assert layer["norm1"]["scale"].dtype == torch.bfloat16
    assert cp["final_norm"]["scale"].dtype == torch.float32
    assert cp["embed"]["tokens"].dtype == torch.bfloat16
    # idempotent: a cast tree passes through without a copy
    again = M.compute_params(cp, "bfloat16")
    wq = again["groups"][0][0]["layer_0"]["mixer"]["wq"]
    assert wq.data_ptr() == layer["mixer"]["wq"].data_ptr()
    scale = again["groups"][0][0]["layer_0"]["norm1"]["scale"]
    assert scale.data_ptr() == layer["norm1"]["scale"].data_ptr()
    toks = _tokens(2, 2, 16, tcfg.vocab_size)
    pcfg = ParallelConfig(compute_dtype="bfloat16",
                          kv_cache_dtype="bfloat16")
    logits, _ = M.forward(tcfg, pcfg, tparams, {"tokens": toks},
                          attn_impl="kernel")
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


def _reference_cast(p):
    """The reference's rule (src/repro/models/model.py:109-111)."""
    return (p.astype(jnp.bfloat16) if p.dtype == jnp.float32 and p.ndim > 1
            else p)


def _cast_leaf(cp, path, rep):
    node, rest = (cp["groups"][path[1]][rep], path[2:]) \
        if path[0] == "groups" else (cp, path)
    for key in rest:
        node = node[key]
    return node


# the architectures of other mixers and FFNs (tests/test_torch_archs.py)
OTHER_ARCHS = ["deepseek-v2-lite-16b", "xlstm-1.3b",
               "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", ["radar-lm-100m", "zamba2-1.2b"]
                         + OTHER_ARCHS)
def test_bf16_cast_tree_equals_the_reference_leaf_by_leaf(arch):
    from repro_torch.models.convert import _flatten, _port_leaves

    jcfg, tcfg, jparams, tparams = _lm(arch)
    want = _flatten(jax.tree.map(_reference_cast, jparams))
    cp = M.compute_params(tparams, "bfloat16")
    n = 0
    for path, rep, _owner, _name in _port_leaves(tparams):
        w = np.asarray(want[path] if rep is None else want[path][rep])
        got = _cast_leaf(cp, path, rep)
        assert str(got.dtype)[6:] == str(w.dtype), path
        bits = np.uint16 if w.dtype == jnp.bfloat16 else np.uint32
        as_int = torch.int16 if bits is np.uint16 else torch.int32
        np.testing.assert_array_equal(got.view(as_int).numpy().view(bits),
                                      w.view(bits), err_msg=str(path))
        n += 1
    assert n == len(want) + sum(
        (len(tparams["groups"][p[1]]) - 1 for p in want if p[0] == "groups"))
    if arch == "zamba2-1.2b":
        mixer = cp["groups"][0][0]["layer_0"]["mixer"]
        for name in ("A_log", "D", "dt_bias", "norm_scale"):
            assert mixer[name].dtype == torch.bfloat16, name
        assert cp["shared"]["norm1"]["scale"].dtype == torch.float32
        assert cp["shared"]["concat_proj"].dtype == torch.bfloat16
    # float32 leaves of the new mixers and FFNs, stacked in the reference,
    # go to bf16 in the compute tree, exactly as there
    f32_leaves = {
        "deepseek-v2-lite-16b": [(1, "layer_0", "ffn", "router")],
        "llama4-maverick-400b-a17b": [(0, "layer_1", "ffn", "router")],
        "xlstm-1.3b": [(0, "layer_0", "mixer", "gate_bias"),
                       (0, "layer_0", "mixer", "norm_scale"),
                       (0, "layer_1", "mixer", "bias"),
                       (0, "layer_1", "mixer", "norm_scale")]}.get(arch, [])
    for g, layer, part, name in f32_leaves:
        assert tparams["groups"][g][0][layer][part][name].dtype == \
            torch.float32
        assert cp["groups"][g][0][layer][part][name].dtype == \
            torch.bfloat16, (layer, name)


# ---------------------------------------------------------------------------
# prefill and decode, with their caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 8])
def test_prefill_and_decode_match_reference(radar_lm, chunk):
    jcfg, tcfg, jparams, tparams = radar_lm
    B, S, L = 2, 24, 32
    toks = _tokens(3, B, S + 2, tcfg.vocab_size)
    jc = JM.init_caches(jcfg, JPCFG, batch=B, max_len=L)
    jl, jc = jax_prefill(jcfg, JPCFG, jparams, jc, jnp.asarray(toks[:, :S]),
                         chunk=chunk)
    tc = M.init_caches(tcfg, PCFG, batch=B, max_len=L, device="cpu")
    tl, tc = prefill(tcfg, PCFG, tparams, tc, torch.from_numpy(toks[:, :S]),
                     chunk=chunk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for idx in (S, S + 1):
        step = toks[:, idx:idx + 1]
        jl, jc = jax_decode(jcfg, JPCFG, jparams, jc, jnp.asarray(step),
                            jnp.int32(idx))
        tl, tc = decode(tcfg, PCFG, tparams, tc, torch.from_numpy(step), idx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for jg, tg in zip(jc, tc):
        for jone, tone in zip(jg, tg):
            for name in ("k", "v"):
                assert tuple(tone[name].shape) == jone[name].shape
                np.testing.assert_allclose(tone[name].numpy(),
                                           np.asarray(jone[name]), **TOL)


def test_decode_step_writes_the_cache_in_place(radar_lm):
    _, tcfg, _, tparams = radar_lm
    caches = M.init_caches(tcfg, PCFG, batch=1, max_len=12, device="cpu")
    k_before = caches[0][0]["k"]
    ptr = k_before.data_ptr()
    toks = torch.from_numpy(_tokens(4, 1, 5, tcfg.vocab_size))
    _, out = M.decode_step(tcfg, PCFG, tparams, caches, toks, 0,
                           attn_impl="kernel")
    assert out[0][0]["k"] is k_before and k_before.data_ptr() == ptr
    assert k_before[:, :, :, :5].abs().sum() > 0
    assert torch.all(k_before[:, :, :, 5:] == 0)
    with pytest.raises(ValueError, match="cannot take"):
        M.decode_step(tcfg, PCFG, tparams, caches, toks, 10)


def test_prefill_then_decode_continues_the_forward_pass(radar_lm):
    _, tcfg, _, tparams = radar_lm
    toks = torch.from_numpy(_tokens(5, 2, 17, tcfg.vocab_size))
    caches = M.init_caches(tcfg, PCFG, batch=2, max_len=17, device="cpu")
    _, caches = prefill(tcfg, PCFG, tparams, caches, toks[:, :16])
    dec, _ = decode(tcfg, PCFG, tparams, caches, toks[:, 16:], 16)
    full, _ = M.forward(tcfg, PCFG, tparams, {"tokens": toks},
                        attn_impl="kernel")
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), **TOL)


# ---------------------------------------------------------------------------
# greedy generation through both engines
# ---------------------------------------------------------------------------

def _top2_margins(tcfg, tparams, seq):
    """Top-1 minus top-2 logit at every position of one sequence."""
    logits, _ = M.forward(tcfg, PCFG, tparams, {"tokens": seq[None]},
                          attn_impl="kernel")
    top2 = torch.topk(logits[0], 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


@pytest.mark.parametrize("max_batch", [None, 2])
def test_greedy_generation_matches_reference_engine(radar_lm, max_batch):
    jcfg, tcfg, jparams, tparams = radar_lm
    rng = np.random.default_rng(6)
    lens = (12, 9, 12)
    prompts = [rng.integers(2, tcfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lens]
    new = 6
    jeng = JaxEngine(jcfg, JPCFG, jparams, max_len=32)
    jout = jeng.generate([JaxRequest(p, max_new_tokens=new) for p in prompts],
                         seed=1, max_batch=max_batch)
    flash_attention.launches = 0
    teng = Engine(tcfg, PCFG, tparams, max_len=32, device="cpu")
    tout = teng.generate([Request(p, max_new_tokens=new) for p in prompts],
                         seed=1, max_batch=max_batch)
    # CPU tensors take the plain version: no kernel launch
    assert flash_attention.launches == 0
    n_batches = 1 if max_batch is None else 2
    assert teng.decode_steps == n_batches * new
    for p, j, t in zip(prompts, jout, tout):
        assert t.prompt_len == j.prompt_len and t.finished == j.finished
        # compare up to the first step whose top-1/top-2 margin is within
        # the forward pass's tolerance (there the argmax may flip)
        pad = np.zeros(t.prompt_len - len(p), np.int32)     # left padding
        seq = np.concatenate([pad, p, np.asarray(j.tokens, np.int32)])
        margins = _top2_margins(tcfg, tparams, torch.from_numpy(seq))
        low = torch.nonzero(margins[t.prompt_len - 1:-1] <= TOL["atol"])
        n_safe = int(low[0]) if len(low) else new
        assert n_safe >= 3, f"margins {margins.tolist()}"
        np.testing.assert_array_equal(np.asarray(t.tokens)[:n_safe],
                                      np.asarray(j.tokens)[:n_safe])
        assert len(t.tokens) == len(j.tokens) == new


def test_engine_stops_at_eos_and_keeps_order(radar_lm):
    _, tcfg, _, tparams = radar_lm
    eng = Engine(tcfg, PCFG, tparams, max_len=20, device="cpu")
    prompt = np.arange(2, 10, dtype=np.int32)
    first = eng.generate([Request(prompt, max_new_tokens=4)])[0]
    eos = int(first.tokens[1])
    outs = eng.generate([Request(prompt, max_new_tokens=4, eos_id=eos),
                         Request(prompt, max_new_tokens=2)])
    assert outs[0].finished == "eos" and list(outs[0].tokens) == list(
        first.tokens[:2])
    assert outs[1].finished == "length" and len(outs[1].tokens) == 2
    assert eng.generate([]) == []
    # temperature sampling is deterministic in the seed
    hot = [Request(prompt, max_new_tokens=5, temperature=1.0)]
    a = eng.generate(hot, seed=3)[0].tokens
    assert np.array_equal(a, eng.generate(hot, seed=3)[0].tokens)
    assert a.dtype == np.int32


def test_engine_runs_on_the_gpu_unless_told_otherwise(radar_lm, monkeypatch):
    _, tcfg, _, tparams = radar_lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tcfg, PCFG, tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(tcfg, 0)
    meta = M.init_params(tcfg, 0, device="meta")
    with pytest.raises(ValueError, match="params lie on"):
        Engine(tcfg, PCFG, meta, device="cpu")


# ---------------------------------------------------------------------------
# parameter count, converter, token batches, command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["zamba2-1.2b"] + OTHER_ARCHS)
def test_count_params_matches_reference_at_full_width(arch):
    tcfg = get_any_config(arch)
    want = JM.count_params(jax_config(arch))
    assert M.count_params(tcfg) == want == tcfg.param_count()
    assert M.active_param_count(tcfg) == JM.active_param_count(
        jax_config(arch))
    if arch == "radar-lm-100m":
        assert 100e6 < want < 110e6
    if arch == "zamba2-1.2b":
        assert want == 1_178_699_904
    if arch == "deepseek-v2-lite-16b":
        assert want == 15_706_470_400
        assert M.active_param_count(tcfg) == 2_661_136_384
    if arch == "xlstm-1.3b":
        assert want == 1_524_347_216


def test_init_params_shapes_follow_reference(radar_lm):
    jcfg, tcfg, _, _ = radar_lm
    jtree = JM.param_specs(jcfg)
    tp = M.init_params(tcfg, 7, device="cpu")
    assert tuple(tp["embed"]["tokens"].shape) == jtree["embed"]["tokens"].shape
    wq = jtree["groups"][0]["layer_0"]["mixer"]["wq"].shape
    assert len(tp["groups"][0]) == wq[0]
    assert tuple(tp["groups"][0][0]["layer_0"]["mixer"]["wq"].shape) == wq[1:]
    # same seed, same numbers; another seed, others
    again = M.init_params(tcfg, 7, device="cpu")
    other = M.init_params(tcfg, 8, device="cpu")
    w = tp["groups"][0][1]["layer_0"]["ffn"]["w_up"]
    assert torch.equal(w, again["groups"][0][1]["layer_0"]["ffn"]["w_up"])
    assert not torch.equal(w, other["groups"][0][1]["layer_0"]["ffn"]["w_up"])
    d_in, d_out = w.shape
    assert abs(float(w.std()) - (2.0 / (d_in + d_out)) ** 0.5) < 0.01


def _tree(radar_lm):
    return jax.tree.map(np.asarray, radar_lm[2])


def test_converter_raises_on_a_missing_leaf(radar_lm):
    tree = _tree(radar_lm)
    del tree["groups"][0]["layer_0"]["ffn"]["w_up"]
    with pytest.raises(ValueError, match="lack groups/0/layer_0/ffn/w_up"):
        from_reference(radar_lm[1], tree, device="cpu")


def test_converter_raises_on_an_extra_leaf(radar_lm):
    tree = _tree(radar_lm)
    tree["groups"][0]["layer_0"]["mixer"]["bq"] = np.zeros((2, 128),
                                                           np.float32)
    with pytest.raises(ValueError, match="does not have.*mixer/bq"):
        from_reference(radar_lm[1], tree, device="cpu")


def test_converter_raises_on_a_wrong_shape_or_repeat_count(radar_lm):
    tree = _tree(radar_lm)
    tree["final_norm"]["scale"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="final_norm/scale"):
        from_reference(radar_lm[1], tree, device="cpu")
    tree = _tree(radar_lm)
    wq = tree["groups"][0]["layer_0"]["mixer"]["wq"]
    tree["groups"][0]["layer_0"]["mixer"]["wq"] = wq[:1]
    with pytest.raises(ValueError, match="stacked repeats"):
        from_reference(radar_lm[1], tree, device="cpu")


@pytest.fixture(scope="module")
def token_archive(tmp_path_factory):
    from repro.etl import generate_raw_archive, ingest
    from repro.store import ObjectStore, Repository

    raw = ObjectStore(str(tmp_path_factory.mktemp("raw")))
    generate_raw_archive(raw, n_scans=5, n_az=90, n_gates=128, n_sweeps=2,
                         seed=13)
    path = str(tmp_path_factory.mktemp("repo"))
    ingest(raw, Repository.create(path), batch_size=5)
    return path


@pytest.mark.parametrize("seq_len, batch, sweep", [(256, 4, 0), (64, 3, 1),
                                                   (1024, 2, 0)])
def test_radar_token_batches_bitwise_equal(token_archive, seq_len, batch,
                                           sweep):
    from repro.core import RadarArchive as JaxArchive
    from repro.data.radar_tokens import RadarTokenDataset as JaxDataset
    from repro.store import Repository as JaxRepository
    from repro_torch.core import RadarArchive
    from repro_torch.data import RadarTokenDataset, TokenizerSpec
    from repro_torch.store import Repository

    jds = JaxDataset(JaxArchive(JaxRepository.open(token_archive)).session(),
                     vcp="VCP-212", sweep=sweep, seq_len=seq_len)
    tds = RadarTokenDataset(RadarArchive(Repository.open(token_archive))
                            .session(), vcp="VCP-212", sweep=sweep,
                            seq_len=seq_len)
    for s, (jb, tb) in enumerate(zip(jds.batches(batch, seed=3),
                                     tds.batches(batch, seed=3))):
        assert jb.keys() == tb.keys()
        for key in jb:
            assert jb[key].dtype == tb[key].dtype
            assert jb[key].tobytes() == tb[key].tobytes(), key
        if s == 2:
            break
    dbz = np.array([np.nan, -40.0, 0.0, 33.3, 70.0], np.float32)
    assert TokenizerSpec().encode(dbz).tolist() == [2, 2, 86, 174, 255]


def test_serve_command_line_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import serve
    from repro_torch.store import Repository

    serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                "--prompt-len", "8", "--new-tokens", "3", "--max-len", "16",
                "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "3 completions, 9 tokens" in out and "on cpu" in out
    # --ckpt loads the newest checkpoint (tests/test_torch_train.py); a
    # repository that holds none is refused
    Repository.create(str(tmp_path / "empty"))
    with pytest.raises(SystemExit, match="no checkpoint"):
        serve.main(["--reduced", "--ckpt", str(tmp_path / "empty"),
                    "--device", "cpu"])
