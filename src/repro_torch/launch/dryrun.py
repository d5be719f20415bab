"""Multi-node dry run: trace and cost every (arch × shape × mesh) cell.

The port of the reference package's ``launch/dryrun.py``.  The reference
compiles each cell for 512 placeholder host devices; here the
placeholders are a *fake process group*
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once, moving nothing) at world 256 or 512, over which the
production H100 meshes are built (``launch.mesh``: ``(data, model) = (32,
8)`` and ``(pod, data, model) = (2, 32, 8)``).  Parameters, optimizer
state, caches and batches are meta tensors laid out by the sharding rules,
so no device is touched and nothing is allocated.

Per cell the dry run:
  1. builds the step (``launch.steps``) and traces it once on the
     single-group mesh AND the two-group mesh — the trace succeeding is
     the deliverable;
  2. records the memory per device: the bytes of the arguments one device
     holds (``argument_bytes_per_device``, the rules' arithmetic), the
     peak of bytes the step's ops kept live at once
     (``temp_bytes_per_device``) and their sum; for a train cell also
     what its layers keep beyond their inputs from the forward to the
     backward pass under its remat policy
     (``remat_kept_bytes_per_device``, from the probes);
  3. costs the step: FLOPs, HBM bytes and collective bytes by kind
     (``launch.costing``; train and prefill cells from the probes, decode
     cells from the traced step) and the three roofline terms on the
     single-group mesh.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch zamba2-1.2b --shape long_500k \\
      --mesh pod
  python -m repro_torch.launch.dryrun --all --out results/dryrun
  python -m repro_torch.launch.dryrun --list    # the 40 cells / skips
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Iterator, Optional

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import costing
from repro_torch.launch.mesh import PRODUCTION_SHAPE, make_production_mesh
from repro_torch.launch.steps import (build_cell, default_pcfg, trace_cell)


def cell_plan():
    """The 40 assigned cells: (arch, shape, run|skip, reason)."""
    plan = []
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if shape == "long_500k" and not cfg.sub_quadratic:
                plan.append((arch, shape, "skip",
                             "full-attention arch: long_500k designated "
                             "sub-quadratic-only (DESIGN.md §7)"))
            else:
                plan.append((arch, shape, "run", ""))
    return plan


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """A fake default process group of ``world`` ranks (this process is
    rank 0) for as long as the block runs; torn down after, also on
    error."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world(mesh_name: str) -> int:
    shape, _names = PRODUCTION_SHAPE[mesh_name == "multipod"]
    n = 1
    for s in shape:
        n *= s
    return n


def _mem_stats(tr) -> dict:
    return {
        "argument_bytes_per_device": int(tr.argument_bytes_per_device),
        "param_bytes_per_device": int(tr.param_bytes_per_device),
        "temp_bytes_per_device": int(tr.temp_bytes_per_device),
        "peak_bytes_per_device": int(tr.peak_bytes_per_device),
    }


def run_cell(arch: str, shape: str, *, meshes=("pod", "multipod"),
             do_cost: bool = True, n_microbatches: int = 0, attn_impl: Optional[str] = None,
             kernel_bytes: bool = False) -> dict:
    """Build, trace and cost one (arch, shape) cell across meshes."""
    out = {"arch": arch, "shape": shape, "status": "ok", "meshes": {},
           "attn_impl": attn_impl, "kernel_bytes": kernel_bytes}
    kind = SHAPES[shape].kind
    pcfg = default_pcfg(kind, n_microbatches=n_microbatches)
    for mesh_name in meshes:
        with fake_group(_world(mesh_name)):
            mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                        device_type="cpu")
            t0 = time.time()
            prog = build_cell(arch, shape, mesh, pcfg=pcfg,
                              attn_impl=attn_impl)
            tr = trace_cell(prog, mesh)
            rec = {"devices": tr.devices,
                   "trace_s": round(time.time() - t0, 1),
                   "memory": _mem_stats(tr)}
            runtime_cost = tr.global_cost()
            rec["runtime_cost"] = dataclasses.asdict(runtime_cost)
            if mesh_name == "pod" and do_cost:
                if kind == "decode":
                    # the traced step is unrolled: its counts are complete
                    total, parts = runtime_cost, {}
                    if kernel_bytes:
                        # bytes from the fused-kernel attention model
                        kprog = build_cell(arch, shape, mesh, pcfg=pcfg,
                                           attn_impl="kernel_proxy")
                        kc = trace_cell(kprog, mesh).global_cost()
                        total = dataclasses.replace(
                            total, bytes_accessed=kc.bytes_accessed,
                            raw_bytes=kc.raw_bytes)
                else:
                    total, parts, live = costing.probe_cell(
                        get_config(arch), prog.static["pcfg"], mesh,
                        SHAPES[shape],
                        attn_bytes_impl=("kernel_proxy" if kernel_bytes
                                         else "blocked"))
                    if kind == "train":
                        # what the layers' forward passes keep beyond
                        # their inputs for the backward pass
                        rec["memory"]["remat_kept_bytes_per_device"] = \
                            live["stored"]
                mf = costing.model_flops(get_config(arch), SHAPES[shape])
                rec["cost"] = dataclasses.asdict(total)
                rec["cost_parts"] = {k: dataclasses.asdict(v)
                                     for k, v in parts.items()}
                rec["roofline"] = total.roofline(tr.devices)
                rec["model_flops"] = mf
                rec["useful_flops_ratio"] = (
                    mf / total.flops if total.flops else 0.0)
            out["meshes"][mesh_name] = rec
            del prog, mesh
    return out


def main(argv=None) -> None:
    """CLI entry point; see the module docstring."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--unscanned", action="store_true",
                    help="refused: the port's layers are a Python loop, "
                         "so there is no scanned form to unroll")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = auto-size to the 4 GiB/device residual budget")
    ap.add_argument("--attn-impl", default=None,
                    help="override the cell's attention impl "
                         "(blocked|naive|flash_decode)")
    ap.add_argument("--kernel-bytes", action="store_true",
                    help="memory probe models attention as the fused "
                         "kernel (q/k/v/o streams)")
    ap.add_argument("--out", default=None, help="directory for JSON records")
    args = ap.parse_args(argv)
    if args.unscanned:
        ap.error("--unscanned has no counterpart in the port: its layers "
                 "are a Python loop, traced one by one already")

    plan = cell_plan()
    if args.list:
        for arch, shape, action, why in plan:
            print(f"{arch:28s} {shape:12s} {action:4s} {why}")
        n_run = sum(1 for p in plan if p[2] == "run")
        print(f"-- {n_run} runnable cells, {len(plan) - n_run} documented "
              f"skips, {len(plan)} total")
        return

    todo = [(a, s) for a, s, act, _ in plan if act == "run"]
    if not args.all:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all / --list) required")
        todo = [(args.arch, args.shape)]

    meshes = (("pod", "multipod") if args.mesh == "both" else (args.mesh,))
    outdir = Path(args.out) if args.out else None
    if outdir:
        outdir.mkdir(parents=True, exist_ok=True)

    for arch, shape in todo:
        try:
            rec = run_cell(arch, shape, meshes=meshes,
                           do_cost=not args.no_cost,
                           n_microbatches=args.microbatches,
                           attn_impl=args.attn_impl,
                           kernel_bytes=args.kernel_bytes)
        except Exception as e:  # a failed cell is a bug: record and continue
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        line = json.dumps(rec)
        if outdir:
            (outdir / f"{arch}__{shape}.json").write_text(line)
        if rec["status"] == "ok":
            first = next(iter(rec["meshes"]))
            m = rec["meshes"][first]
            peak = m["memory"]["peak_bytes_per_device"]
            roof = m.get("roofline", {})
            print(f"[ok] {arch} {shape} ({first}, {m['devices']} devices): "
                  f"peak/dev {peak / 2**30:.2f} GiB"
                  + (f"; dominant {roof['dominant']}; bound "
                     f"{roof['bound_s'] * 1e3:.2f} ms; useful "
                     f"{m['useful_flops_ratio']:.2f}" if roof else ""))
        else:
            print(f"[error] {arch} {shape}: {rec['error']}")


if __name__ == "__main__":
    main()
