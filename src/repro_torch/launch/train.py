"""Training from the command line: a model, its data, checkpoints in the
store and the fault-tolerance supervisor, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch radar-lm-100m --steps 200 --batch 8 --seq 512 \
        --data <archive path or 'synthetic'> --ckpt /tmp/ckpts
    PYTHONPATH=src python -m repro_torch.launch.train --arch radar-lm-100m \
        --reduced --device cpu

The port of the reference package's ``launch/train.py``, with its flags.
``--device`` defaults to ``cuda``; ``--device cpu`` trains on the CPU.
Off the CPU the model computes in bfloat16 (float32 master parameters and
moments), on the CPU in float32, as the reference does on its backends.
``--remat`` picks the per-layer rematerialization (``block``, the
default, keeps each layer's input and recomputes the rest; ``dots`` also
keeps the matmul outputs; ``none`` keeps every activation).  ``--data`` is
``synthetic`` (``data.make_batch``, seed ``1000 + step``) or
the path of an archive (``data.RadarTokenDataset``: sweep 0 of ``--vcp``,
one scan a sequence).  With ``--ckpt`` every run opens (or creates) the
checkpoint repository and resumes from its newest step, saving every
``--ckpt-every`` steps and at the end; the batches resume with it.

On a mesh: ``--model-axis N`` lays the run out on a ``("data", "model")``
mesh of ``world / N`` by ``N`` over a process group (``launch.mesh.
make_host_mesh``): the state as DTensors by ``distributed.sharding.
param_shardings`` (the moments likewise, ``launch.steps.
opt_shardings_like``), each batch's rows over ``data`` by
``batch_shardings``.  Rank and world come from ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``; NCCL on the
card, gloo on the CPU); with none set the script starts a group of one
itself, and tears down whatever group it started.  Every rank makes the
same batches and the same initial state from the same seeds and keeps
its own shards; rank 0 writes the checkpoints, gathered whole, and a run
resumes onto any mesh (each rank reads the chunks under its shards).
Without ``--model-axis`` (and outside ``torchrun``) the run is on one
device with no mesh, as before.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --model-axis 2 --reduced --device cpu
"""

from __future__ import annotations

import argparse
import os
import socket
import time
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_any_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.data import RadarTokenDataset, make_batch
from repro_torch.distributed import (Supervisor, batch_shardings,
                                     param_shardings)
from repro_torch.distributed.sharding import distribute, gather_full
from repro_torch.launch.mesh import axis_sizes, make_host_mesh, set_mesh
from repro_torch.launch.steps import opt_shardings_like
from repro_torch.models.model import REMAT, count_params
from repro_torch.radar._device import resolve_device
from repro_torch.store import ObjectStore, Repository
from repro_torch.store.icechunk import NotFound
from repro_torch.train import (AdamWConfig, CheckpointManager, TrainState,
                               init_train_state, make_train_step,
                               train_state_specs)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="radar-lm-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", choices=REMAT,
                    default="block",
                    help="per-layer rematerialization: none, block (keep "
                         "each layer's input) or dots (also keep the "
                         "matmul outputs with no batch dims)")
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a radar archive store path")
    ap.add_argument("--vcp", default="VCP-212")
    ap.add_argument("--ckpt", default=None, help="checkpoint store path")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-axis", type=int, default=None,
                    help="lay the run out on a (data, model) mesh with "
                         "this many ranks on 'model' (default: no mesh, "
                         "or 1 under torchrun)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--reduced", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu (training on the CPU)")
    return ap


def _batches(args, cfg, device) -> Iterator:
    """``batch_iter(start_step)``: the run's batches from ``start_step``
    on, as tensors on ``device``."""
    if args.data == "synthetic":
        def batch_iter(start_step: int):
            step = start_step
            while True:
                yield make_batch(cfg, args.batch, args.seq, seed=1000 + step,
                                 device=device)
                step += 1
        return batch_iter
    ds = RadarTokenDataset(Repository.open(args.data).readonly_session(),
                           vcp=args.vcp, seq_len=args.seq)

    def batch_iter(start_step: int):
        for b in ds.batches(args.batch, seed=17, start_step=start_step):
            yield {k: torch.from_numpy(b[k]).to(device)
                   for k in ("tokens", "targets")}
    return batch_iter


def main(argv=None) -> Dict[str, Any]:
    """CLI entry point; see the module docstring.  Returns the run's
    record: ``start_step``, ``losses`` (step -> loss), ``step_s`` (host
    seconds of each step, synchronised), ``peak_bytes`` (on the GPU) and
    the final ``state``."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if args.model_axis is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        args.model_axis = 1
    if args.model_axis is None:
        return _run(args, device, None)
    started = _start_group(device)
    try:
        if cuda:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             "0")))
            torch.cuda.set_device(device)
        mesh = make_host_mesh(args.model_axis, device_type=device.type)
        with set_mesh(mesh):
            return _run(args, device, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _start_group(device: torch.device) -> bool:
    """Join ``torchrun``'s process group, or start a group of one; returns
    whether this call started it (a group the caller set up is kept)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    return True


def _run(args, device: torch.device, mesh) -> Dict[str, Any]:
    cuda = device.type == "cuda"
    rank = dist.get_rank() if mesh is not None else 0
    cfg = get_any_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(n_microbatches=args.microbatches,
                          remat=args.remat,
                          compute_dtype="bfloat16" if cuda else "float32")
    ocfg = AdamWConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                       total_steps=args.steps)
    if rank == 0:
        print(f"arch={cfg.name} params={count_params(cfg) / 1e6:.1f}M "
              f"device={device}"
              + (f" mesh={axis_sizes(mesh)}" if mesh is not None else ""))
    batch_iter = _batches(args, cfg, device)
    specs = train_state_specs(cfg, ocfg, pcfg)
    sshard = bshard = None
    if mesh is not None:
        pshard = param_shardings(cfg, pcfg, specs.params, mesh)
        sshard = TrainState(params=pshard,
                            opt=opt_shardings_like(pshard, mesh))

    # -- state: fresh init or checkpoint resume -----------------------------
    mgr: Optional[CheckpointManager] = None
    start_step = 0
    state = None
    if args.ckpt:
        mgr = CheckpointManager(_open_repo(args.ckpt, rank, mesh))
        latest = mgr.latest_step()
        if latest is not None:
            if rank == 0:
                print(f"resuming from checkpoint step {latest}")
            state = mgr.restore(specs, step=latest, device=device,
                                shardings=sshard, mesh=mesh)
            start_step = latest
    if state is None:
        state = init_train_state(cfg, ocfg, pcfg, seed=0, device=device)
        if mesh is not None:
            state = distribute(state, sshard, mesh)

    step_fn = make_train_step(cfg, ocfg, pcfg)
    sup = Supervisor(model_parallel=args.model_axis or 1,
                     devices_per_host=torch.cuda.device_count() if cuda else 1)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    it = batch_iter(start_step)
    losses: Dict[int, float] = {}
    step_s = []
    t_last = time.time()
    for step in range(start_step, args.steps):
        batch = next(it)
        if mesh is not None:
            if bshard is None:
                bshard = batch_shardings(mesh, batch)
            batch = distribute(batch, bshard, mesh)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss_total"])        # synchronises
        step_s.append(time.perf_counter() - t0)
        losses[step + 1] = loss
        if rank == 0 and ((step + 1) % args.log_every == 0
                          or step == start_step):
            dt = time.time() - t_last
            t_last = time.time()
            print(f"step {step + 1:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"({dt / args.log_every:.2f}s/step)")
            sup.observe("host0", step_time_s=dt / args.log_every)
            action = sup.decide()
            if action.kind != "none":
                print(f"supervisor: {action.kind} ({action.reason})")
        if mgr and (step + 1) % args.ckpt_every == 0:
            sid = _save(mgr, step + 1, state, rank, mesh,
                        message=f"train step {step + 1}")
            if rank == 0:
                print(f"checkpoint @ step {step + 1} -> snapshot {sid[:12]}")
    if mgr and args.steps not in mgr.steps():
        _save(mgr, args.steps, state, rank, mesh, message="final")
        if rank == 0:
            print(f"final checkpoint @ step {args.steps}")
    if rank == 0:
        print("done.")
    return {"start_step": start_step, "losses": losses, "step_s": step_s,
            "peak_bytes": (torch.cuda.max_memory_allocated(device) if cuda
                           else None),
            "state": state}


def _open_repo(path: str, rank: int, mesh) -> Repository:
    """Open (or, on rank 0, create) the checkpoint repository."""
    if rank == 0:
        store = ObjectStore(path)
        try:
            repo = Repository.open(store)
            repo.branch_head("main")
        except NotFound:
            repo = Repository.create(store)
    if mesh is not None:
        dist.barrier()
    return repo if rank == 0 else Repository.open(ObjectStore(path))


def _save(mgr: CheckpointManager, step: int, state, rank: int, mesh,
          *, message: str) -> str:
    """One checkpoint commit: on a mesh every rank gathers the state
    whole and rank 0 writes it; the others wait for the commit."""
    if mesh is None:
        return mgr.save(step, state, message=message)
    full = gather_full(state)
    sid = mgr.save(step, full, message=message) if rank == 0 else ""
    dist.barrier()
    return sid


if __name__ == "__main__":
    main()
