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
``--data`` is ``synthetic`` (``data.make_batch``, seed ``1000 + step``) or
the path of an archive (``data.RadarTokenDataset``: sweep 0 of ``--vcp``,
one scan a sequence).  With ``--ckpt`` every run opens (or creates) the
checkpoint repository and resumes from its newest step, saving every
``--ckpt-every`` steps and at the end; the batches resume with it.  The
port trains on one device: ``--model-axis`` other than 1 needs the
sharding of ROADMAP item 8.3 and raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch.configs import get_any_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.data import RadarTokenDataset, make_batch
from repro_torch.distributed import Supervisor
from repro_torch.models.model import count_params
from repro_torch.radar._device import resolve_device
from repro_torch.store import ObjectStore, Repository
from repro_torch.store.icechunk import NotFound
from repro_torch.train import (AdamWConfig, CheckpointManager,
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
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a radar archive store path")
    ap.add_argument("--vcp", default="VCP-212")
    ap.add_argument("--ckpt", default=None, help="checkpoint store path")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-axis", type=int, default=1)
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
    if args.model_axis != 1:
        raise NotImplementedError(
            "--model-axis other than 1 needs tensor-parallel sharding, not "
            "ported yet: ROADMAP, 'Modules to port', item 8.3")
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    cfg = get_any_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(n_microbatches=args.microbatches,
                          compute_dtype="bfloat16" if cuda else "float32")
    ocfg = AdamWConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                       total_steps=args.steps)
    print(f"arch={cfg.name} params={count_params(cfg) / 1e6:.1f}M "
          f"device={device}")
    batch_iter = _batches(args, cfg, device)

    # -- state: fresh init or checkpoint resume -----------------------------
    mgr: Optional[CheckpointManager] = None
    start_step = 0
    state = None
    if args.ckpt:
        store = ObjectStore(args.ckpt)
        try:
            repo = Repository.open(store)
            repo.branch_head("main")
        except NotFound:
            repo = Repository.create(store)
        mgr = CheckpointManager(repo)
        latest = mgr.latest_step()
        if latest is not None:
            print(f"resuming from checkpoint step {latest}")
            state = mgr.restore(train_state_specs(cfg, ocfg, pcfg),
                                step=latest, device=device)
            start_step = latest
    if state is None:
        state = init_train_state(cfg, ocfg, pcfg, seed=0, device=device)

    step_fn = make_train_step(cfg, ocfg, pcfg)
    sup = Supervisor(model_parallel=1,
                     devices_per_host=torch.cuda.device_count() if cuda else 1)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    it = batch_iter(start_step)
    losses: Dict[int, float] = {}
    step_s = []
    t_last = time.time()
    for step in range(start_step, args.steps):
        batch = next(it)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss_total"])        # synchronises
        step_s.append(time.perf_counter() - t0)
        losses[step + 1] = loss
        if (step + 1) % args.log_every == 0 or step == start_step:
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
            sid = mgr.save(step + 1, state, message=f"train step {step + 1}")
            print(f"checkpoint @ step {step + 1} -> snapshot {sid[:12]}")
    if mgr and args.steps not in mgr.steps():
        mgr.save(args.steps, state, message="final")
        print(f"final checkpoint @ step {args.steps}")
    print("done.")
    return {"start_step": start_step, "losses": losses, "step_s": step_s,
            "peak_bytes": (torch.cuda.max_memory_allocated(device) if cuda
                           else None),
            "state": state}


if __name__ == "__main__":
    main()
