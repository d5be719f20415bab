"""The port's launch tooling against the reference's: the dry run's cell
plan, ``model_flops``, ``CostTerms`` and the roofline; the dry run itself
on fake process groups of 256 and 512 ranks.

``python -m repro_torch.launch.dryrun --list`` prints the reference's
``--list`` line for line (the reference's runs in a subprocess: importing
its dry run sets ``XLA_FLAGS``); ``model_flops`` is exactly the
reference's for every architecture and shape; ``CostTerms``' algebra and
roofline equal the reference's given the same constants.  The dry run of
``llama3.2-1b`` ``train_4k`` and ``zamba2-1.2b`` ``long_500k`` (in a
subprocess, so its fake process group never meets another test) traces
on both production meshes, costs on the single-group one, and holds per
device the parameter bytes the reference's specs leave there.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import ParallelConfig as JaxPCfg  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.jaxcompat import abstract_mesh as jabstract_mesh  # noqa: E402
from repro.launch import costing as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import costing as C  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "2"        # beside the suite's other workers
    return env


def test_cell_plan_prints_the_reference_list(capsys):
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                          "--list"], env=_env(), capture_output=True,
                         text=True, timeout=120, check=True).stdout
    dryrun.main(["--list"])
    assert capsys.readouterr().out == ref
    assert len(dryrun.cell_plan()) == 40


def test_unscanned_is_refused(capsys):
    """The reference's ``--unscanned`` unrolls its scanned layers; the
    port's are a Python loop already, so the flag is refused, not taken
    silently."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--unscanned", "--arch", "llama3.2-1b", "--shape",
                     "train_4k"])
    assert e.value.code == 2
    assert "--unscanned has no counterpart" in capsys.readouterr().err


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_model_flops_equal_the_reference_exactly(arch):
    for shape in sorted(JSHAPES):
        assert C.model_flops(ARCHS[arch], SHAPES[shape]) == \
            JC.model_flops(JARCHS[arch], JSHAPES[shape]), shape


def test_cost_terms_algebra_and_roofline_equal_the_reference():
    a = (1.0, 2.0, 3.0, {"all-reduce": 3.0}, 4.0)
    b = (10.0, 20.0, 30.0, {"all-gather": 30.0}, 40.0)
    got = (C.CostTerms(*a) + C.CostTerms(*b)).scaled(2.0)
    want = (JC.CostTerms(*a) + JC.CostTerms(*b)).scaled(2.0)
    assert vars(got) == vars(want)
    from repro.launch import mesh as jmesh
    consts = dict(peak_flops=jmesh.PEAK_BF16_FLOPS, hbm_bw=jmesh.HBM_BW,
                  link_bw=jmesh.ICI_BW_PER_LINK)
    for terms in ((1e15, 2e12, 3e9), (0.0, 819e9 * 8, 0.0), (5e9, 0, 7e12)):
        for n in (1, 4, 256):
            assert C.CostTerms(*terms).roofline(n, **consts) == \
                JC.CostTerms(*terms).roofline(n)


def test_roofline_defaults_are_the_h100s():
    t = C.CostTerms(flops=989e12 * 4, bytes_accessed=3.35e12 * 8,
                    collective_bytes=50e9 * 2)
    r = t.roofline(1)
    np.testing.assert_allclose([r["t_compute_s"], r["t_memory_s"],
                                r["t_collective_s"]], [4.0, 8.0, 2.0])
    assert r["dominant"] == "memory" and r["bound_s"] == 8.0
    assert (tmesh.PEAK_BF16_FLOPS, tmesh.HBM_BW, tmesh.NVLINK_BW,
            tmesh.INTER_NODE_BW) == (989e12, 3.35e12, 450e9, 50e9)


def _reference_param_bytes(arch, kind, mesh_shape, names):
    """What the reference's specs leave on one device of the parameters
    of a cell's kind (float32 to train, bf16 to serve)."""
    jcfg = JARCHS[arch]
    dtype = jnp.float32 if kind == "train" else jnp.bfloat16
    jpcfg = JaxPCfg(param_dtype="float32" if kind == "train" else "bfloat16")
    specs = JM.param_specs(jcfg, dtype=dtype)
    mesh = jabstract_mesh(mesh_shape, names)
    sizes = dict(zip(names, mesh_shape))
    shard, _ = jax.tree_util.tree_flatten(
        JS.param_shardings(jcfg, jpcfg, specs, mesh),
        is_leaf=lambda x: hasattr(x, "spec"))
    total = 0
    for leaf, sh in zip(jax.tree.leaves(specs), shard):
        split = 1
        for entry in tuple(sh.spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                split *= sizes[a] if a else 1
        total += math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize \
            // split
    return total


def run_dryrun(tmp_path, arch, shape):
    out = tmp_path / "dry"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "both", "--out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"[ok] {arch} {shape} (pod, 256 devices)" in proc.stdout, \
        proc.stdout + proc.stderr[-3000:]
    return json.loads((out / f"{arch}__{shape}.json").read_text())


def check_cell(rec, arch, shape):
    """Both meshes traced; the single-group one costed; the parameters'
    bytes per device the reference's."""
    assert rec["status"] == "ok", rec.get("error")
    kind = SHAPES[shape].kind
    for name, shape_names in (("pod", ((32, 8), ("data", "model"))),
                              ("multipod", ((2, 32, 8),
                                            ("pod", "data", "model")))):
        m = rec["meshes"][name]
        assert m["devices"] == math.prod(shape_names[0])
        mem = m["memory"]
        assert mem["param_bytes_per_device"] == _reference_param_bytes(
            arch, kind, *shape_names)
        assert 0 < mem["param_bytes_per_device"] \
            <= mem["argument_bytes_per_device"]
        assert mem["temp_bytes_per_device"] > 0
        assert mem["peak_bytes_per_device"] == \
            mem["argument_bytes_per_device"] + mem["temp_bytes_per_device"]
    pod = rec["meshes"]["pod"]
    assert pod["cost"]["flops"] > 0 and pod["cost"]["bytes_accessed"] > 0
    assert pod["cost"]["collective_bytes"] == pytest.approx(
        sum(pod["cost"]["per_collective"].values()))
    assert pod["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert pod["model_flops"] == C.model_flops(ARCHS[arch], SHAPES[shape])


@pytest.mark.parametrize("arch,shape", [("llama3.2-1b", "train_4k"),
                                        ("zamba2-1.2b", "long_500k")])
def test_dry_run_on_fake_groups_of_256_and_512(arch, shape, tmp_path):
    rec = run_dryrun(tmp_path, arch, shape)
    check_cell(rec, arch, shape)
    pod = rec["meshes"]["pod"]
    if shape == "train_4k":
        # the parameters' FSDP gathers and the gradients' reduce-scatters,
        # the tensor-parallel all-reduces; the probes' parts reassemble
        per = pod["cost"]["per_collective"]
        assert per["all-gather"] > 0 and per["reduce-scatter"] > 0
        assert per["all-reduce"] > 0
        assert set(pod["cost_parts"]) == {"group0_x16", "boundary",
                                          "optimizer"}
    else:
        # one token a step on a 524 288-deep state: no probes
        assert pod["cost_parts"] == {}
