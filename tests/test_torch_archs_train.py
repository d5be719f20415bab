"""Training, checkpoints and the command lines of the architectures built
of MoE, MLA and xLSTM, the port against the reference package, on the CPU.

From the same parameters (the reference's ``init_params`` tree, converted)
and the same batch (``make_batch`` draws the same numbers in both
packages), one AdamW step with float32 and with int8 moments (the MoE
layers on the sorted dispatch, sLSTM on its cost proxy, as the reference
trains), a checkpoint written by either package restored in the other,
and ``launch.serve`` / ``launch.train`` with ``--reduced`` on the CPU, for
reduced ``deepseek-v2-lite-16b``, ``xlstm-1.3b`` and
``llama4-maverick-400b-a17b``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import train as jtrain  # noqa: E402
from repro.configs import get_any_config as jax_config  # noqa: E402
from repro.configs.base import ParallelConfig as JaxPCfg  # noqa: E402
from repro.data.batches import make_batch as jmake_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.store import Repository as JRepo  # noqa: E402
from repro_torch.configs import get_any_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import (from_reference,  # noqa: E402
                                        to_reference)
from repro_torch.store import ObjectStore, Repository  # noqa: E402
from repro_torch.train import (AdamWConfig, CheckpointManager,  # noqa: E402
                               TrainState, make_adamw, make_train_step,
                               train_state_specs)
from repro_torch.train.tree import leaves  # noqa: E402

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


OCFG = AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
JOCFG = jtrain.AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)


def _np(x):
    return (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, dtype=np.float32))


def _states(arch, moments):
    """The reference's train state and the port's, from the same
    parameters."""
    jcfg, tcfg, jparams, _tp = _model(arch)
    pcfg = ParallelConfig(compute_dtype="float32", opt_moment_dtype=moments)
    jpcfg = JaxPCfg(compute_dtype="float32", opt_moment_dtype=moments)
    jst = jtrain.TrainState(jparams,
                            jtrain.make_adamw(JOCFG, jpcfg)[0](jparams))
    params = to_reference(from_reference(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    st = TrainState(params, make_adamw(OCFG, pcfg)[0](params))
    return jcfg, tcfg, pcfg, jpcfg, jst, st


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_one_adamw_step_matches_the_reference(arch, moments):
    jcfg, tcfg, pcfg, jpcfg, jst, st = _states(arch, moments)
    jnew, jm = jtrain.make_train_step(jcfg, JOCFG, jpcfg)(
        jst, jmake_batch(jcfg, 2, 24, seed=5))
    new, m = make_train_step(tcfg, OCFG, pcfg)(
        st, make_batch(tcfg, 2, 24, seed=5, device="cpu"))
    for k in ("loss_total", "grad_norm", "lr"):
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-6)
    if tcfg.moe is not None:
        for k in ("moe_load_balance", "moe_z_loss"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]),
                                       rtol=1e-4)
    ported = leaves(new.params)
    want = jax.tree.leaves(jnew.params)
    assert len(ported) == len(want)
    for a, b in zip(ported, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_packages(arch, writer, tmp_path):
    jcfg, tcfg, pcfg, jpcfg, jst, st = _states(arch, "float32")
    path = str(tmp_path / "ck")
    if writer == "port":
        CheckpointManager(Repository.create(ObjectStore(path))).save(3, st)
        back = jtrain.CheckpointManager(JRepo.open(path)).restore(
            jtrain.train_state_specs(jcfg, JOCFG, jpcfg))
        pairs = list(zip(leaves(st), jax.tree.leaves(back)))
    else:
        jtrain.CheckpointManager(JRepo.create(path)).save(3, jst)
        back = CheckpointManager(Repository.open(path)).restore(
            train_state_specs(tcfg, OCFG, pcfg), device="cpu")
        pairs = list(zip(leaves(back), jax.tree.leaves(jst)))
        # the restored parameters build the port's model
        restored = from_reference(tcfg, back.params, device="cpu")
        assert sum(p.numel() for p in restored.parameters()) == \
            M.count_params(tcfg)
    assert pairs
    for a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-1.3b",
                                  "llama4-maverick-400b-a17b"])
def test_serve_command_line_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    outs = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "8",
                       "--new-tokens", "3", "--max-len", "16",
                       "--max-batch", "2"])
    assert len(outs) == 3 and all(len(o.tokens) == 3 for o in outs)
    assert "3 completions, 9 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-1.3b"])
def test_train_command_line_on_the_cpu(arch, tmp_path):
    from repro_torch.launch import serve, train

    ck = str(tmp_path / "ck")
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--warmup", "2", "--log-every", "2", "--steps",
            "4", "--ckpt", ck, "--ckpt-every", "2"]
    rec = train.main(args)
    assert sorted(rec["losses"]) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for v in rec["losses"].values())
    assert CheckpointManager(Repository.open(ck)).steps() == [2, 4]
    outs = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--ckpt", ck, "--requests", "2", "--prompt-len", "6",
                       "--new-tokens", "2", "--max-len", "12"])
    assert len(outs) == 2
