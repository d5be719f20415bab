"""The port's zamba2 (Mamba-2 backbone + weight-shared attention block)
against the reference package's, on the CPU.

``zamba2-1.2b.reduced(n_layers=7)`` in both packages gives the groups
``[(2, [mamba2 x3, shared_attn]), (1, [mamba2])]``: the shared block and
the remainder group.  The reference's parameters go through
``repro_torch.models.convert`` into the port, and the same token batches,
made from a seed with numpy, go through both: the forward pass and loss
(the reference's through its Pallas kernels in interpret mode and through
its non-kernel routes), prefill (single shot and chunked) and decode with
every cache, and greedy generation through both engines.  Also: the
converter on the shared block and the serve command line.
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
from repro_torch.kernels import flash_attention, mamba2_scan  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve import Engine, Request, decode, prefill  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)        # tests/test_serve.py:33
PCFG = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                      remat="none")
JPCFG = JaxPCfg(compute_dtype="float32", kv_cache_dtype="float32",
                remat="none")
ARCH = "zamba2-1.2b"
N_LAYERS = 7


@pytest.fixture(scope="module")
def zamba():
    jcfg = jax_config(ARCH).reduced(n_layers=N_LAYERS)
    tcfg = get_any_config(ARCH).reduced(n_layers=N_LAYERS)
    jparams = JM.init_params(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, from_reference(tcfg, tree, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)
                                                ).astype(np.int32)


def test_groups_hold_the_shared_block_and_the_remainder(zamba):
    jcfg, tcfg, jparams, tparams = zamba
    groups = [(reps, [s.mixer for s in unit])
              for reps, unit in M.layer_groups(tcfg)]
    assert groups == [(2, ["mamba2"] * 3 + ["shared_attn"]), (1, ["mamba2"])]
    assert set(jparams) == {k for k, _ in tparams.items()} == {
        "embed", "groups", "final_norm", "shared"}
    # group parameters skip the shared_attn position, as the reference's
    assert list(tparams["groups"][0][0].keys()) == list(
        jparams["groups"][0].keys()) == ["layer_0", "layer_1", "layer_2"]


@pytest.mark.parametrize("jimpl", ["pallas", "blocked"])
def test_forward_and_loss_match_reference(zamba, jimpl):
    jcfg, tcfg, jparams, tparams = zamba
    toks = _tokens(1, 2, 40, tcfg.vocab_size)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = JM.forward(jcfg, JPCFG, jparams, jbatch, attn_impl=jimpl)
    jloss, _ = JM.loss_fn(jcfg, JPCFG, jparams, jbatch, attn_impl=jimpl)
    for impl in ("kernel", "blocked"):
        got, aux = M.forward(tcfg, PCFG, tparams, batch, attn_impl=impl)
        assert got.dtype == torch.float32 and aux == {}
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        loss, metrics = M.loss_fn(tcfg, PCFG, tparams, batch, attn_impl=impl)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        assert float(metrics["loss"]) == float(loss)


@pytest.mark.parametrize("chunk", [None, 8])
def test_prefill_and_decode_match_reference(zamba, chunk):
    jcfg, tcfg, jparams, tparams = zamba
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
    seen = set()
    for jg, tg in zip(jc, tc):
        for jone, tone in zip(jg, tg):
            assert set(tone) == set(jone)
            for name in tone:
                seen.add(name)
                assert tuple(tone[name].shape) == jone[name].shape
                assert tone[name].dtype == torch.float32
                np.testing.assert_allclose(tone[name].numpy(),
                                           np.asarray(jone[name]), **TOL)
    assert seen == {"k", "v", "ssm", "conv"}


def test_prefill_then_decode_continues_the_forward_pass(zamba):
    """The SSM and conv states the steps write in place carry the scan
    on: a decode after prefill gives the forward pass's last logits."""
    _, tcfg, _, tparams = zamba
    toks = torch.from_numpy(_tokens(5, 2, 17, tcfg.vocab_size))
    caches = M.init_caches(tcfg, PCFG, batch=2, max_len=17, device="cpu")
    ssm0 = caches[0][0]["ssm"]
    _, caches = prefill(tcfg, PCFG, tparams, caches, toks[:, :16])
    assert caches[0][0]["ssm"] is ssm0 and ssm0.abs().sum() > 0
    dec, _ = decode(tcfg, PCFG, tparams, caches, toks[:, 16:], 16)
    full, _ = M.forward(tcfg, PCFG, tparams, {"tokens": toks},
                        attn_impl="kernel")
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), **TOL)


def _top2_margins(tcfg, tparams, seq):
    """Top-1 minus top-2 logit at every position of one sequence."""
    logits, _ = M.forward(tcfg, PCFG, tparams, {"tokens": seq[None]},
                          attn_impl="kernel")
    top2 = torch.topk(logits[0], 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


def test_greedy_generation_matches_reference_engine(zamba):
    jcfg, tcfg, jparams, tparams = zamba
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, tcfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (12, 9, 12)]
    new = 6
    jout = JaxEngine(jcfg, JPCFG, jparams, max_len=32).generate(
        [JaxRequest(p, max_new_tokens=new) for p in prompts], seed=1)
    flash_attention.launches = mamba2_scan.launches = 0
    teng = Engine(tcfg, PCFG, tparams, max_len=32, device="cpu")
    tout = teng.generate([Request(p, max_new_tokens=new) for p in prompts],
                         seed=1)
    # CPU tensors take the plain versions: no kernel launch
    assert flash_attention.launches == mamba2_scan.launches == 0
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


def test_bf16_forward_and_decode_run(zamba):
    """bf16 compute as the card runs it: group leaves in bf16, the Mamba-2
    states float32, finite logits that stay near the float32 ones."""
    _, tcfg, _, tparams = zamba
    bf16 = ParallelConfig(compute_dtype="bfloat16",
                          kv_cache_dtype="bfloat16")
    toks = torch.from_numpy(_tokens(7, 2, 12, tcfg.vocab_size))
    caches = M.init_caches(tcfg, bf16, batch=2, max_len=16, device="cpu")
    logits, caches = prefill(tcfg, bf16, tparams, caches, toks)
    assert caches[0][0]["ssm"].dtype == torch.float32
    assert caches[0][3]["k"].dtype == torch.bfloat16
    want, _ = prefill(tcfg, PCFG, tparams,
                      M.init_caches(tcfg, PCFG, 2, 16, device="cpu"), toks)
    assert torch.isfinite(logits).all()
    assert float((logits - want).abs().max()) < 0.25 * float(
        want.abs().max())


# ---------------------------------------------------------------------------
# converter and command line
# ---------------------------------------------------------------------------

def test_converter_carries_the_shared_block(zamba):
    jcfg, tcfg, jparams, tparams = zamba
    shared = tparams["shared"]
    assert [k for k, _ in shared.items()] == ["norm1", "concat_proj", "mixer",
                                              "ffn_shared"]
    np.testing.assert_array_equal(shared["concat_proj"].numpy(),
                                  np.asarray(jparams["shared"]["concat_proj"]))
    np.testing.assert_array_equal(
        shared["ffn_shared"]["w_down"].numpy(),
        np.asarray(jparams["shared"]["ffn_shared"]["w_down"]))
    np.testing.assert_array_equal(
        tparams["groups"][1][0]["layer_0"]["mixer"]["A_log"].numpy(),
        np.asarray(jparams["groups"][1]["layer_0"]["mixer"]["A_log"][0]))
    tree = jax.tree.map(np.asarray, jparams)
    del tree["shared"]["mixer"]["wk"]
    with pytest.raises(ValueError, match="lack shared/mixer/wk"):
        from_reference(tcfg, tree, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["shared"]["concat_proj"] = tree["shared"]["concat_proj"][:-1]
    with pytest.raises(ValueError, match="shared/concat_proj"):
        from_reference(tcfg, tree, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["shared"]["norm2"] = {"scale": np.ones(tcfg.d_model, np.float32)}
    with pytest.raises(ValueError, match="does not have.*shared/norm2"):
        from_reference(tcfg, tree, device="cpu")


def test_serve_command_line_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
                "2", "--prompt-len", "8", "--new-tokens", "3", "--max-len",
                "16"])
    out = capsys.readouterr().out
    assert "2 completions, 6 tokens" in out and "on cpu" in out
