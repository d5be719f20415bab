"""The reference's training step on a mesh of host devices, run in a
subprocess.

``reference_mesh_losses(cases, data=, model=)`` starts one Python process
with ``XLA_FLAGS=--xla_force_host_platform_device_count=<data · model>``,
lays the reference's training state and batch out on
``make_host_mesh(model)`` (a mesh of ``data`` by ``model``) with its own
sharding rules, takes one
``make_train_step`` step under ``jax.jit`` for each case and returns each
case's ``loss_total``.  A case is ``(arch, batch, seq, n_microbatches)``:
the arch's ``.reduced()`` configuration in float32 with ``remat="none"``,
``init_params(key(0))``, ``make_batch(seed=1000)`` and the default
``AdamWConfig``.  The test process keeps its own JAX devices as they are.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

LIMIT_S = 600.0


def reference_mesh_losses(cases, *, data: int = 2, model: int = 1,
                          limit_s: float = LIMIT_S):
    """``[loss_total of one reference step for each case]`` on a mesh of
    ``data`` by ``model`` host devices."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                        f"platform_device_count={data * model}").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__),
         json.dumps([list(c) for c in cases]), str(model)],
        env=env, capture_output=True, text=True, timeout=limit_s)
    if proc.returncode != 0:
        raise AssertionError(f"the reference on a mesh of {data} x {model} "
                             f"failed:\n"
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _main(cases, model: int) -> None:
    import jax

    from repro import train as jtrain
    from repro.configs import get_any_config
    from repro.configs.base import ParallelConfig
    from repro.data.batches import make_batch
    from repro.distributed.sharding import batch_shardings, param_shardings
    from repro.jaxcompat import set_mesh
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import opt_shardings_like

    mesh = make_host_mesh(model)
    out = []
    for arch, batch, seq, n in cases:
        cfg = get_any_config(arch).reduced()
        pcfg = ParallelConfig(compute_dtype="float32", remat="none",
                              n_microbatches=n)
        ocfg = jtrain.AdamWConfig()
        specs = jtrain.train_state_specs(cfg, ocfg, pcfg)
        pshard = param_shardings(cfg, pcfg, specs.params, mesh)
        sshard = jtrain.TrainState(params=pshard,
                                   opt=opt_shardings_like(pshard, mesh))
        b = make_batch(cfg, batch, seq, seed=1000)
        bshard = batch_shardings(mesh, jax.eval_shape(lambda: b))
        with set_mesh(mesh):
            state = jax.jit(
                lambda k: jtrain.init_train_state(cfg, ocfg, pcfg, k),
                out_shardings=sshard)(jax.random.key(0))
            step = jax.jit(jtrain.make_train_step(cfg, ocfg, pcfg),
                           in_shardings=(sshard, bshard),
                           out_shardings=(sshard, None))
            _state, metrics = step(state, b)
            out.append(float(metrics["loss_total"]))
    print(json.dumps(out))


if __name__ == "__main__":
    _main(json.loads(sys.argv[1]), int(sys.argv[2]))
