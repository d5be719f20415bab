"""The architectures built of MoE, MLA and xLSTM, the port against the
reference package, on the CPU.

``deepseek-v2-lite-16b`` (MLA and the MoE FFN after a dense first layer),
``xlstm-1.3b`` (mLSTM and sLSTM) and ``llama4-maverick-400b-a17b`` (MoE on
every second layer) at ``.reduced()`` size, from the reference's
parameters converted into the port (``from_reference``), on the same
token batches, made from numpy seeds: the forward pass and loss with the
aux terms (the reference through its Pallas kernel in interpret mode),
prefill (single shot and chunked) then decode with their caches, greedy
generation through both engines, bf16 compute, and the converter's checks
on the new leaves.  The layers alone: ``test_torch_moe.py``,
``test_torch_mla.py``, ``test_torch_xlstm.py``; training, checkpoints and
the command lines: ``test_torch_archs_train.py``.
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
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve import Engine, Request, decode, prefill  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)          # tests/test_serve.py:33
PCFG = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                      remat="none")
JPCFG = JaxPCfg(compute_dtype="float32", kv_cache_dtype="float32",
                remat="none")
ARCHS = ["deepseek-v2-lite-16b", "xlstm-1.3b", "llama4-maverick-400b-a17b"]

_MODELS = {}


def _model(arch):
    """(jcfg, tcfg, jparams, tparams) at reduced size, the port's
    parameters converted from the reference's (one per arch a module)."""
    if arch not in _MODELS:
        jcfg = jax_config(arch).reduced()
        tcfg = get_any_config(arch).reduced()
        jparams = JM.init_params(jcfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, jparams)
        _MODELS[arch] = (jcfg, tcfg, jparams,
                         from_reference(tcfg, tree, device="cpu"))
    return _MODELS[arch]


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropless", [False, True])
def test_forward_and_loss_match_reference(arch, dropless):
    jcfg, tcfg, jparams, tparams = _model(arch)
    toks = _tokens(1, 2, 40, tcfg.vocab_size)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jaux = JM.forward(jcfg, JPCFG, jparams, jbatch, attn_impl="pallas",
                            moe_dropless=dropless)
    for impl in ("kernel", "blocked"):
        got, aux = M.forward(tcfg, PCFG, tparams, batch, attn_impl=impl,
                             moe_dropless=dropless)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert set(aux) == set(jaux)
        for k in aux:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=1e-4)
    if dropless:
        return
    # the loss adds the moe_* aux terms (the reference's loss_fn takes no
    # dropless flag: its MoE layers dispatch sorted)
    jloss, jm = JM.loss_fn(jcfg, JPCFG, jparams, jbatch, attn_impl="pallas")
    loss, metrics = M.loss_fn(tcfg, PCFG, tparams, batch, attn_impl="kernel")
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               **TOL)
    assert float(loss) == pytest.approx(float(metrics["loss"]) + sum(
        float(v) for k, v in metrics.items() if k.startswith("moe_")))
    assert bool(aux) == (tcfg.moe is not None)
    if aux:
        assert float(loss) > float(metrics["loss"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk", [None, 32])
def test_prefill_and_decode_match_reference(arch, chunk):
    """S = 72 > 64: the single-shot prefill's MoE layers take the sorted
    dispatch and the chunked prefill's (32 a chunk) the dropless one, in
    both packages; then two decode steps."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    B, S, L = 2, 72, 80
    toks = _tokens(3, B, S + 2, tcfg.vocab_size)
    jc = JM.init_caches(jcfg, JPCFG, batch=B, max_len=L)
    jl, jc = jax_prefill(jcfg, JPCFG, jparams, jc, jnp.asarray(toks[:, :S]),
                         chunk=chunk)
    tc = M.init_caches(tcfg, PCFG, batch=B, max_len=L, device="cpu")
    before = dict(moe.dispatches)
    tl, tc = prefill(tcfg, PCFG, tparams, tc, torch.from_numpy(toks[:, :S]),
                     chunk=chunk)
    if tcfg.moe is not None:
        kind = "sorted" if chunk is None else "dropless"
        assert moe.dispatches[kind] > before[kind]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for idx in (S, S + 1):
        step = toks[:, idx:idx + 1]
        jl, jc = jax_decode(jcfg, JPCFG, jparams, jc, jnp.asarray(step),
                            jnp.int32(idx))
        tl, tc = decode(tcfg, PCFG, tparams, tc, torch.from_numpy(step), idx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    seen = set()
    for jg, tg in zip(jc, tc):
        for jone, tone in zip(jg, tg):
            assert set(tone) == set(jone)
            for name in tone:
                seen.add(name)
                assert tuple(tone[name].shape) == jone[name].shape
                np.testing.assert_allclose(tone[name].numpy(),
                                           np.asarray(jone[name]), **TOL)
    want = {"deepseek-v2-lite-16b": {"latent", "k_rope"},
            "xlstm-1.3b": {"C", "conv", "c", "n", "h"},
            "llama4-maverick-400b-a17b": {"k", "v"}}[arch]
    assert seen == want


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_continues_the_forward_pass(arch):
    """The caches and states the steps write in place carry the model on:
    a decode after a prefill gives the dropless forward's last logits."""
    _jcfg, tcfg, _jp, tparams = _model(arch)
    toks = torch.from_numpy(_tokens(5, 2, 17, tcfg.vocab_size))
    caches = M.init_caches(tcfg, PCFG, batch=2, max_len=17, device="cpu")
    _, caches = prefill(tcfg, PCFG, tparams, caches, toks[:, :16])
    dec, _ = decode(tcfg, PCFG, tparams, caches, toks[:, 16:], 16)
    full, _ = M.forward(tcfg, PCFG, tparams, {"tokens": toks},
                        attn_impl="kernel", moe_dropless=True)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), **TOL)


def _top2_margins(tcfg, tparams, seq):
    logits, _ = M.forward(tcfg, PCFG, tparams, {"tokens": seq[None]},
                          attn_impl="kernel", moe_dropless=True)
    top2 = torch.topk(logits[0], 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_matches_reference_engine(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, tcfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (12, 9, 12)]
    new = 6
    jout = JaxEngine(jcfg, JPCFG, jparams, max_len=32).generate(
        [JaxRequest(p, max_new_tokens=new) for p in prompts], seed=1)
    flash_attention.launches = 0
    teng = Engine(tcfg, PCFG, tparams, max_len=32, device="cpu")
    tout = teng.generate([Request(p, max_new_tokens=new) for p in prompts],
                         seed=1)
    assert flash_attention.launches == 0      # CPU tensors: plain version
    assert teng.decode_steps == new
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


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_decode_run(arch):
    """bf16 compute as the card runs it: finite logits near the float32
    ones, the recurrent states float32, the latent cache bf16."""
    _jcfg, tcfg, _jp, tparams = _model(arch)
    bf16 = ParallelConfig(compute_dtype="bfloat16",
                          kv_cache_dtype="bfloat16")
    toks = torch.from_numpy(_tokens(7, 2, 12, tcfg.vocab_size))
    caches = M.init_caches(tcfg, bf16, batch=2, max_len=16, device="cpu")
    logits, caches = prefill(tcfg, bf16, tparams, caches, toks)
    dec, caches = decode(tcfg, bf16, tparams, caches, toks[:, :1], 12)
    for group in caches:
        for one in group:
            for name, c in one.items():
                want = (torch.bfloat16 if name in ("latent", "k_rope", "k",
                                                   "v") else torch.float32)
                assert c.dtype == want, name
    want, _ = prefill(tcfg, PCFG, tparams,
                      M.init_caches(tcfg, PCFG, 2, 16, device="cpu"), toks)
    assert torch.isfinite(logits).all() and torch.isfinite(dec).all()
    assert float((logits - want).abs().max()) < 0.25 * float(
        want.abs().max())


def test_converter_checks_the_new_leaves():
    jcfg, tcfg, jparams, _tp = _model("deepseek-v2-lite-16b")
    tree = jax.tree.map(np.asarray, jparams)
    router = tree["groups"][1]["layer_0"]["ffn"]["router"]
    del tree["groups"][1]["layer_0"]["ffn"]["router"]
    with pytest.raises(ValueError, match="lack groups/1/layer_0/ffn/router"):
        from_reference(tcfg, tree, device="cpu")
    tree["groups"][1]["layer_0"]["ffn"]["router"] = router[:1]
    with pytest.raises(ValueError, match="stacked repeats"):
        from_reference(tcfg, tree, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["groups"][1]["layer_0"]["mixer"]["w_uk"] = np.zeros((3, 2, 2),
                                                             np.float32)
    with pytest.raises(ValueError, match="mixer/w_uk"):
        from_reference(tcfg, tree, device="cpu")
    _j, xcfg, xparams, _t2 = _model("xlstm-1.3b")
    tree = jax.tree.map(np.asarray, xparams)
    tree["groups"][0]["layer_1"]["mixer"]["extra"] = np.zeros((2, 1))
    with pytest.raises(ValueError, match="does not have.*mixer/extra"):
        from_reference(xcfg, tree, device="cpu")


