#!/usr/bin/env python3
"""One kernel's wrapper against another checkout's, in one process on one card.

    python3 tools/kernel_ab.py --kernel flash_attention --against OTHER/src
    python3 tools/kernel_ab.py --kernel mamba2_scan --against OTHER/src
    python3 tools/kernel_ab.py --kernel mamba2_scan --dtype float32 \
        --against OTHER/src
    python3 tools/kernel_ab.py --kernel zr_accum --against OTHER/src
    python3 tools/kernel_ab.py --kernel grid_update --against OTHER/src
    python3 tools/kernel_ab.py --kernel grid_map --against OTHER/src

Loads ``OTHER/src/repro_torch/kernels`` as a package of its own beside
this checkout's (that package imports nothing else of ``repro_torch``) and
runs the two wrappers of ``--kernel`` in turns (this, other, other, this;
``ROUNDS`` times) with ``chip_smoke.py``'s helpers:

* the wrapper's host time per call (``chip_smoke.host_us_per_call``: 1000
  calls enqueued on a synchronised card) and its ms per call by CUDA
  events (``<call>_call_ms``, ``chip_smoke.time_cuda``: calls back to
  back, L2 warm) at the
  kernel's decode call and prefill calls on its models' shapes, in
  ``--dtype`` (bfloat16 by default, or float32: the ``f32`` routes):
  ``flash_attention`` at radar-lm-100m's (one query on a 1056-key prefix
  of a 2048-long cache; Sq = Skv = 1024, 12 query and 4 KV heads) and at
  zamba2-1.2b's prefill (32 and 32), and with ``--head-dims`` at
  stablelm-3b's prefill shape (32 and 32 heads, Sq = Skv = 1024) at each
  head dim given (``prefill_D<d>``; the wide kernel above 192 in bf16,
  128 in float32), with SDPA on the same inputs as its
  yardstick (``chip_smoke.sdpa``), ``mamba2_scan`` at zamba2-1.2b's (one
  token from a state; 1024 tokens from a state, B = 8, H = 64, P = N =
  64);
* ``--arch`` (by default the kernel's model) at full width in ``--dtype``,
  random weights from seed 0, 8 prompts of 1024 random tokens
  (``chip_smoke.serve_split``): prefill ms and decode step ms, the model's
  attention or Mamba-2 layers calling one wrapper or the other.

``zr_accum`` and ``grid_update`` serve no model; for them each turn takes,
per call, the kernel's device time (``chip_smoke.profiled_device_ms``),
its CUDA-event time of back-to-back calls and the wrapper's host time:
``zr_accum`` at the QPE shape (64 scans of 720 x 1192), ``grid_update``
as each checkout patches one QPE scan (89% of the gates wet, the
archive's share, added into a (1, 858 240) accumulation) and one CAPPI
row (the 240 x 240 canvas set where in reach): in place at the cell list
where the checkout has ``ops.grid_scatter_``, else into a fresh state
through the equivalent pos map (``ops.grid_update``, before the kernel
became a scatter).

``grid_map`` is timed per call with the card's L2 flushed before each
(1 GiB written: ``chip_smoke.time_cuda_cold``) and back to back behind
a spin of the card (``chip_smoke.time_cuda_warm``), by CUDA events, on
``chip_smoke.py``'s 64 random scans of
VCP-212's five sweeps: the nearest CAPPI map (240 x 240), the 600 x 600
IDW one, and column-max's five sweeps.  A checkout whose
``ops.grid_map`` takes ``order`` gets its map in the kernel's order
(``radar.grid.device_map``) and column-max in one call; an older one
gets the maps in grid order and column-max as five calls and the
``torch.fmax`` fold.  Beside them, as a yardstick of a plain gather (not
the same function), ``torch.index_select`` of the nearest map's gates.

Prints one JSON line of medians, with the card's name and power limit as
``nvidia-smi`` gives them; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 4            # turns of (this, other, other, this)
STEPS = 8             # decode steps timed per turn
# kernel -> (the model module whose ``kops`` calls it, its default arch)
KERNELS = {"flash_attention": ("attention", "radar-lm-100m"),
           "mamba2_scan": ("ssm", "zamba2-1.2b")}
# kernels timed alone -> the profiler's name filter for their kernels
ALONE = {"zr_accum": "zr_accum_kernel", "grid_update": "grid_"}


def load_ops(src, name: str):
    """The ``ops`` module of the ``repro_torch.kernels`` package under the
    ``src`` directory ``src``, imported as the package ``name``."""
    pkg = Path(src).resolve() / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops")


def kernel_calls(kernel: str, cs, randn, head_dims=()):
    """({call: a function of an ``ops`` module}, {call: the yardstick's
    call}) for the timed calls, in ``randn``'s dtype; ``head_dims`` adds
    flash_attention's prefill at stablelm-3b's shape at each."""
    import torch

    B, S = cs.LM_PROMPTS, cs.LM_PROMPT_LEN
    if kernel == "flash_attention":
        Hq, Hkv, D = 12, 4, 64
        kv_len = S + cs.LM_NEW_TOKENS
        cache_k, cache_v = (randn(B, Hkv, cs.LM_MAX_LEN, D),
                            randn(B, Hkv, cs.LM_MAX_LEN, D))
        qkv = {"decode": (randn(B, Hq, 1, D), cache_k[:, :, :kv_len],
                          cache_v[:, :, :kv_len]),
               "prefill": (randn(B, Hq, S, D), randn(B, Hkv, S, D),
                           randn(B, Hkv, S, D)),
               "zamba2_prefill": tuple(randn(B, 32, S, D) for _ in range(3))}
        for d in head_dims:
            qkv[f"prefill_D{d}"] = tuple(randn(B, 32, S, d) for _ in range(3))
        return ({call: (lambda ops, a=a: ops.flash_attention(*a))
                 for call, a in qkv.items()},
                {call: (lambda a=a: cs.sdpa(*a, True))
                 for call, a in qkv.items()})
    H, P, N = 64, 64, 64
    h0 = randn(B, H, P, N).float()
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    out = {}
    for call, length in (("decode", 1), ("prefill", S)):
        dt = torch.full((B, length, H), 0.01, device="cuda")
        args = (randn(B, length, H, P), dt, A, randn(B, length, N),
                randn(B, length, N))
        out[call] = (lambda ops, a=args: ops.mamba2_scan(*a, h0=h0))
    return out, {}


def alone_calls(kernel: str, cs):
    """{call: a function of an ``ops`` module} for a kernel timed alone."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    if kernel == "zr_accum":
        dbz = cs.radar_field((cs.N_SCANS, 720, 1192), gen)
        dt_s = torch.rand(cs.N_SCANS, generator=gen, device="cuda") * 200 + 200
        return {"qpe": lambda ops: ops.zr_accum(dbz, dt_s)}
    A, R = 720, 1192
    reach = torch.from_numpy(
        cs.grid_maps()["cappi 240x240 nearest"].in_reach()).cuda()
    masks = {"qpe_fold": ("add", ~cs.storm_mask((A, R), 1.0 - cs.QPE_WET,
                                                gen)),
             "cappi_canvas": ("set", reach)}
    out = {}
    for call, (op, mask) in masks.items():
        cells = torch.nonzero(mask).flatten().to(torch.int32)
        m = cells.numel()
        pos = torch.full(mask.shape, -1, dtype=torch.int32, device="cuda")
        pos[mask] = torch.arange(m, dtype=torch.int32, device="cuda")
        state = (torch.rand((1, mask.numel()), generator=gen, device="cuda")
                 * 50.0 if op == "add" else
                 torch.full((1, mask.numel()), float("nan"), device="cuda"))
        upd = torch.rand((1, m), generator=gen, device="cuda") * 5.0

        def patch(ops, op=op, state=state, upd=upd, cells=cells, pos=pos):
            if hasattr(ops, "grid_scatter_"):
                return ops.grid_scatter_(state, upd, cells, op=op)
            return ops.grid_update(state, upd, pos, op=op)
        out[call] = patch
    return out


def main_alone(args, cs) -> int:
    """The A/B of a kernel that serves no model: device, event and host
    time per call, in turns."""
    import torch

    wrappers = {"this": importlib.import_module("repro_torch.kernels.ops"),
                "other": load_ops(args.against, "other_kernels")}
    calls = alone_calls(args.kernel, cs)
    name = ALONE[args.kernel]
    for ops in wrappers.values():               # build and warm up
        for fn in calls.values():
            fn(ops)
    torch.cuda.synchronize()
    samples = {}
    for _ in range(ROUNDS):
        for which in ("this", "other", "other", "this"):
            ops = wrappers[which]
            for call, fn in calls.items():
                for metric, value in (
                        ("device_ms", cs.profiled_device_ms(
                            lambda: fn(ops), name)),
                        ("event_ms", cs.time_cuda(lambda: fn(ops))),
                        ("host_us", cs.host_us_per_call(lambda: fn(ops),
                                                        n=200))):
                    samples.setdefault((which, f"{call}_{metric}"),
                                       []).append(value)
    out = {"card": cs.card_line(), "kernel": args.kernel,
           "against": args.against, "rounds": ROUNDS}
    for (which, metric), xs in samples.items():
        # a profiler window that kept none of the kernel's events gives
        # None: such samples are dropped and the count says how many stay
        xs = [x for x in xs if x is not None]
        out.setdefault(which, {})[metric] = {
            "median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "n": len(xs)} if xs else None
    print(json.dumps(out))
    return 0


def grid_map_calls(ops, cs, sweeps, stacked):
    """{case: a call} of ``ops.grid_map`` for the three grid_map cases,
    in the form the checkout's ``ops`` takes."""
    import numpy as np
    import torch
    from repro_torch.radar import grid

    maps = cs.grid_maps()
    cases = {"cappi_nearest": ([stacked], [maps["cappi 240x240 nearest"]]),
             "idw_600": ([stacked], [maps["cappi 600x600 idw"]]),
             "column_max": (sweeps, cs.column_max_maps())}
    fused = "order" in inspect.signature(ops.grid_map).parameters
    calls = {}
    for case, (fields, mps) in cases.items():
        if fused:
            dm = grid.device_map(mps, fields[0].shape[1], "cuda")
            calls[case] = (lambda fields=fields, dm=dm: ops.grid_map(
                fields, dm.gate_idx, dm.weights, order=dm.order))
            continue
        per = [(f, torch.from_numpy(np.array(m.gate_idx)).cuda(),
                torch.from_numpy(np.array(m.weights)).cuda())
               for f, m in zip(fields, mps)]

        def split(per=per):
            out = None
            for f, i, w in per:
                y = ops.grid_map(f, i, w)
                out = y if out is None else torch.fmax(out, y)
            return out
        calls[case] = split
    return calls


def main_grid_map(args, cs) -> int:
    """The A/B of grid_map: L2-cold and L2-warm ms per call, in turns."""
    import numpy as np
    import torch

    wrappers = {"this": importlib.import_module("repro_torch.kernels.ops"),
                "other": load_ops(args.against, "other_kernels")}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    A, R = 720, 1192
    S = len(cs.ELEVATIONS)
    sweeps = [cs.radar_field((cs.N_SCANS, A * R), gen) for _ in range(S)]
    stacked = torch.stack(sweeps, dim=1).reshape(cs.N_SCANS, S * A * R)
    calls = {which: grid_map_calls(ops, cs, sweeps, stacked)
             for which, ops in wrappers.items()}
    for case in calls["this"]:                  # build, warm up, compare
        got, want = calls["this"][case](), calls["other"][case]()
        if not cs.bits_equal(got, want):
            raise AssertionError(f"grid_map {case}: the checkouts differ")
    flush = cs.flush_l2()
    gates = torch.from_numpy(np.array(
        cs.grid_maps()["cappi 240x240 nearest"].gate_idx[:, 0])).cuda().long()

    def gather():
        return torch.index_select(stacked, 1, gates)

    samples = {}
    for _ in range(ROUNDS):
        for which in ("this", "other", "other", "this"):
            for case, fn in calls[which].items():
                for metric, value in (
                        ("cold_ms", cs.time_cuda_cold(fn, flush)),
                        ("warm_ms", cs.time_cuda_warm(fn))):
                    samples.setdefault((which, f"{case}_{metric}"),
                                       []).append(value)
        for metric, value in (("cold_ms", cs.time_cuda_cold(gather, flush)),
                              ("warm_ms", cs.time_cuda_warm(gather))):
            samples.setdefault(("index_select", f"cappi_nearest_{metric}"),
                               []).append(value)
    out = {"card": cs.card_line(), "kernel": args.kernel,
           "against": args.against, "rounds": ROUNDS}
    for (which, metric), xs in samples.items():
        out.setdefault(which, {})[metric] = {
            "median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "n": len(xs)}
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel",
                    choices=sorted([*KERNELS, *ALONE, "grid_map"]),
                    default="flash_attention")
    ap.add_argument("--against", required=True,
                    help="the src directory of another checkout")
    ap.add_argument("--arch", default=None,
                    help="the model served (default: the kernel's model)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="the calls' and the served model's dtype (float32: "
                         "the f32 prefill routes)")
    ap.add_argument("--head-dims", default="",
                    help="flash_attention: comma-separated head dims also "
                         "timed at stablelm-3b's prefill shape")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    import chip_smoke as cs

    if args.kernel in ALONE:
        return main_alone(args, cs)
    if args.kernel == "grid_map":
        return main_grid_map(args, cs)
    from repro_torch.configs import get_any_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import model as M

    module, default_arch = KERNELS[args.kernel]
    arch = args.arch or default_arch
    model = importlib.import_module(f"repro_torch.models.{module}")
    wrappers = {"this": model.kops,
                "other": load_ops(args.against, "other_kernels")}
    order = ("this", "other", "other", "this")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    dtype = getattr(torch, args.dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    head_dims = [int(d) for d in args.head_dims.split(",") if d]
    calls, yardsticks = kernel_calls(args.kernel, cs, randn, head_dims)
    cfg = get_any_config(arch)
    pcfg = ParallelConfig(compute_dtype=args.dtype,
                          kv_cache_dtype=args.dtype, remat="none")
    params = M.compute_params(M.init_params(cfg, 0, device="cuda"),
                              pcfg.compute_dtype)
    B, S = cs.LM_PROMPTS, cs.LM_PROMPT_LEN
    prompt = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        2, min(cfg.vocab_size, 256), size=(B, S)).astype(np.int32)).cuda()
    samples = {}
    for which in wrappers:                      # warm-up, each version
        model.kops = wrappers[which]
        cs.serve_split(cfg, pcfg, params, prompt, 1, 2)
    for _ in range(ROUNDS):
        for which in order:
            ops = model.kops = wrappers[which]
            for call, fn in calls.items():
                samples.setdefault((which, f"{call}_host_us"), []).append(
                    cs.host_us_per_call(lambda: fn(ops)))
                samples.setdefault((which, f"{call}_call_ms"), []).append(
                    cs.time_cuda(lambda: fn(ops)))
            pre, dec, _, _ = cs.serve_split(cfg, pcfg, params, prompt, 1,
                                            STEPS)
            samples.setdefault((which, "prefill_ms"), []).extend(pre)
            samples.setdefault((which, "decode_step_ms"), []).extend(dec)
        for call, fn in yardsticks.items():
            samples.setdefault(("sdpa", f"{call}_call_ms"), []).append(
                cs.time_cuda(fn))
    model.kops = wrappers["this"]
    out = {"card": cs.card_line(), "kernel": args.kernel, "arch": arch,
           "dtype": args.dtype, "against": args.against, "rounds": ROUNDS}
    for (which, metric), xs in samples.items():
        out.setdefault(which, {})[metric] = {
            "median": statistics.median(xs), "min": min(xs), "max": max(xs)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
