#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines:

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) into the package's
   ``kernels/build/`` directory;
3. kernel check: each kernel against its plain PyTorch version on the
   card, at the paths' shapes and at ragged ones (``qvp_reduce``,
   ``zr_accum``, ``flash_attention`` and ``mamba2_scan`` with the
   tolerances of the reference package's kernel tests, ``grid_map`` and
   ``grid_update`` bitwise), and twice for bitwise stability;
   ``zr_accum`` also over every 1e-4 dBZ of [-30, 80] with NaN and +-inf
   from an aligned and a misaligned base, its one-exponential rate
   against float64 arithmetic, and a planted fault (the last scan
   dropped) that must fail; ``grid_update`` (in place at an ascending
   cell list) bitwise against its plain version and against the
   reference's pos-mapped function with the equivalent map, untouched
   cells bitwise, at the QPE fold (89% wet as on the archive), a CAPPI
   canvas, ragged shapes and M = 0 and 1, with a planted fault (cells
   shifted by one) that must fail; ``grid_update`` and ``zr_accum``
   timed also by ``torch.profiler`` with the wrapper's host time per
   call, and ``grid_map``'s bound counted in distinct 32-byte sectors of
   the gates its map reads; ``grid_map`` also in the traversal the
   product paths cache with the map (``radar.grid.device_map``) at the
   CAPPI map, a 600 x 600 IDW map and column-max's five sweeps in one
   launch, ragged maps of one and several sweeps, with two planted faults
   (a sweep dropped from the fold, the cell order shifted by one) that
   must fail, and an order out of range that must write nothing, timed
   L2 warm (calls back to back behind a spin of the card) and L2 cold
   (1 GiB written before each call), by CUDA events, against its sector
   bound, column-max against five one-sweep launches and the
   ``torch.fmax`` fold, and beside ``torch.index_select`` of the nearest
   map's gates;
   ``flash_attention`` on each of its three routes (``tc_prefill``, the
   bf16 prefill on the tensor cores; ``decode``, one query against a
   strided prefix of a 2048-long cache, split over the keys; ``f32``, the
   float32 prefill) at radar-lm's, zamba2's, stablelm-3b's (head dim
   80) and deepseek-v2-lite's (MLA: 16 heads of q/k width 192, v
   zero-padded to it) prefill and decode shapes and at 32 ragged ones (D
   16 to 128 in steps of 16), then at head dims no configuration has
   (40, 72, 136, 200, 256: zero columns up to the kernel's width, two
   column groups of v above 128; the prefill on the wide kernel above 192
   in bf16 and above 128 in float32: S once per query tile over k-slices
   of 64 columns, decode in passes of 256 above 256) at ragged shapes
   and, from 256 up, at stablelm's B, heads and S, and a decode of 16
   query heads on each KV head (at D 64 and 320, and at radar-lm's B and
   D), in float32 and bfloat16, each call on the route its dtype and Sq
   choose; at the serve paths' shapes timed beside its plain version and
   ``F.scaled_dot_product_attention``, the decode call also by
   ``torch.profiler``, with the wrapper's host time per call and the
   tensor-core instructions of the built library (``cuobjdump -sass``);
   the wide kernel timed at stablelm's shape at 288 to 512 beside SDPA
   and its bound, and in turns with the narrow kernel at deepseek's D 192
   and at 256 (where it takes over), its SASS checked for serialized
   ``wgmma``;
   ``mamba2_scan`` on each of its three routes (``chunk_tc``, the bf16
   scan on the tensor cores; ``decode``, one token from a state; ``f32``,
   the float32 scan) at zamba2's prefill shape (8 x 1024 tokens, 64 heads,
   P = N = 64) with and without a start state and at its decode shape, in
   float32 and bfloat16, at ragged lengths and widths, and split in two
   halves against the whole, each call on the route its dtype and L
   choose; two planted faults must fail the checks; timed beside its plain
   version (the sequential recurrence), the decode call also by
   ``torch.profiler`` with the wrapper's host time per call, and the
   tensor-core instructions of the built library counted; the wide
   kernel (``bf16_wide``, ``f32_wide``: tensor cores, P in tiles of 64
   over the grid, B and C in slices of 64 columns of N, the state in
   shared memory where its slices fit, else in global memory) for states
   wider than the other kernels hold, at bfloat16 P = 64, N = 192, timed,
   at ragged shapes and at zamba2's B, L and H with P = N = 160, P = 256,
   N = 192 and P = 64, N = 384 and 512, in both dtypes, against the
   sequential recurrence and its plain version with the same roundings,
   timed, its SASS checked for serialized ``wgmma``;
4. the paths, each with every kernel's launch counter set to 0 just
   before it and read just after, on a versioned archive at VCP-212's
   full width (720 azimuths x 1192 gates, its four lowest cuts and the
   top one, cut only in depth):
   a. QVP (top cut) and QPE (lowest cut) through
      ``repro_torch.radar.products.compute_product`` on ``device="cuda"``,
      held against the plain version on the card and the numpy file-based
      baseline;
   b. the grid path: a PPI (``grid_sweep_from_session``), CAPPI and
      column-max (``compute_product``), each held bitwise against the same
      request with ``mode="ref"`` on the card, one ``grid_map`` launch
      each; column-max traced, no ``torch.fmax`` pass;
5. times: each kernel (CUDA events, median) beside its plain version and
   its bound, and each product end to end (QVP and QPE at read_workers 1
   and the host's cores, the grids at the cores), split into store read
   and decode, host-to-device copy, kernel, and device-to-host copy;
6. the incremental path (it appends to the archive): incremental CAPPI,
   column-max and QPE states built at the archive's head, then 1 scan
   appended in a commit of its own; after the append every state catches up
   and is held bitwise against the from-scratch product at that head,
   with ``grid_update``'s launches counted (one per wet scan for QPE,
   none for the grids) and ``grid_map``'s (one per grid update, none for
   QPE; column-max's ``torch.fmax`` calls counted, none);
   b. the federated path: KTLX and KICT archives of the same VCP at full
      width (16 scans each, at KVNX's last 16 scan times) and a
      ``repro_torch.catalog.Catalog`` over the three; federated QVP, QPE
      and the column-max and CAPPI mosaics through ``compute_product(
      catalog, ..., device="cuda")``, each against the same request with
      ``mode="ref"`` (grids bitwise), exactly one ``qvp_reduce``,
      ``zr_accum`` or ``grid_map`` launch per repository, timed at
      ``workers`` 1 and 3 with each repository's session span; a
      time-windowed mosaic fetching fewer chunks than the blind one; an
      incremental mosaic updated after one scan appended to each of KTLX
      and KICT, bitwise against the from-scratch mosaic;
   c. the same catalog served over HTTP (``repro_torch.serve.http``,
      ``ArchiveService(device="cuda")`` behind ``ArchiveServer`` on
      127.0.0.1): 8 concurrent identical QVP requests coalesced onto one
      computation and one ``qvp_reduce`` launch, every body bitwise the
      in-process encoding; QPE, column-max, CAPPI and the column-max
      mosaic cold, then warm from the product cache with no launch, then
      304 on ``If-None-Match``, each against ``mode="ref"`` (header bytes
      equal, grids bitwise); a chunk, a query and a ``/watch`` that sees
      exactly one scan appended to KTLX; cold, in-process, warm and 304
      ms and the body's MB;
   d. store maintenance on KVNX: the head tagged, the QVP sweep's DBZH and
      RHOHV compacted into one tall time chunk (the QVP after bitwise the
      QVP before, chunk payloads decoded before and after), ``history``
      showing it, ``rollback`` to the tag, ``gc(keep_history=False)``
      after the tag is deleted (objects and bytes removed); the QVP read
      through a ``SimulatedLatencyStore`` (50 ms round trips) at
      read_workers 1 and 8, bitwise the local read;
   e. Raw2Zarr: 16 raw VCP-212 volumes at full width (sweeps 0-4, the
      format's 7 moments) from ``repro_torch.etl.generate_raw_archive``,
      ingested by ``repro_torch.etl.ingest`` at workers 8 (registered in a
      ``Catalog`` from its report), then the first 4 volumes at workers 8
      and 1, each into a fresh repository, their snapshot ids equal, stage
      seconds and MB printed; the DataTree view
      of the result; QVP and QPE through ``compute_product`` on it, one
      launch each, against ``mode="ref"``; then a ``LiveFeed`` of 2
      ``live_scan_feed`` scans, the catalog's head advancing with each,
      and an incremental CAPPI updated after each (one ``grid_map``
      launch) bitwise equal to the CAPPI rebuilt from scratch;
7. the LM serve path: radar-lm-100m at full width from
   ``init_params(seed=0)`` serves 8 radar scans of 1024 tokens drawn from
   the archive (``RadarTokenDataset``) through ``Engine.generate``, 32 new
   tokens each, greedy: in float32 the kernel route is held against the
   blocked core (last-position prefill logits within 2e-3, greedy tokens
   equal where the top-1/top-2 margin allows, exactly 12 x (1 + decode
   steps) kernel launches: 12 on the prefill's route, the rest on
   ``decode``), then the bfloat16 run of ``launch.serve`` is
   timed: end to end, prefill, one decode step, the kernel's share, and a
   profiler trace of decode steps;
8. the zamba2 serve path: zamba2-1.2b at full width (38 Mamba-2 layers,
   the shared attention block after every 6) from ``init_params(seed=0)``
   serves the same prompts the same way: float32 kernel route against the
   non-kernel one (the chunked SSD, the sequential recurrence and the
   blocked core), exactly 38 x (1 + decode steps) ``mamba2_scan`` (38 on
   ``f32``, the rest on ``decode``; in bfloat16 38 on ``chunk_tc``) and
   6 x (1 + decode steps) ``flash_attention`` launches; the bf16 prefill's
   last-position logits against the same prefill with only the scan on its
   plain version (row by row, a planted fault rejected); then bfloat16
   timed, with the peak device memory;
   b. the stablelm-3b serve path the same way (32 layers, d_model 2560,
   32/32 heads of 80): float32 kernel route against the blocked core,
   exactly 32 x (1 + decode steps) ``flash_attention`` launches, then
   bfloat16 timed;
   c. the DeepSeek serve path: deepseek-v2-lite-16b at full width (MLA,
   64 routed experts top-6 and 2 shared) in float32 at 4 layers (the
   dense one and 3 MoE layers) the same way, exactly 4 x (1 + decode
   steps) ``flash_attention`` launches (4 on ``f32``), greedy tokens
   compared up to the margins of the engine's own function (a sorted
   prefill, dropless steps); then at full depth (27 layers, its
   parameters made in bfloat16), timed, 27 ``tc_prefill`` launches a
   prefill and 27 ``decode`` a step, every MoE layer's prefill on the
   sorted dispatch and every step on the dropless one, with the
   assignments dropped at capacity;
   d. the xLSTM serve path: xlstm-1.3b at full width in float32 at one
   unit (7 mLSTM and 1 sLSTM layers), the recurrent prefill's
   last-position logits within 2e-3 of the chunked cache-less forward's;
   then bfloat16 at full depth (48 layers) timed; no hand kernel
   launched;
9. the train path: ``repro_torch.launch.train`` trains radar-lm-100m at
   full width with its defaults (batch 8, seq 512, bf16 compute) on
   tokens of the ingested archive for 12 steps, a checkpoint every 6 in
   the port's ``Repository``; rolled back to step 6, a second run
   resumes there and its losses at steps 7-12 stay within 1e-2 relative
   of the first's; ms per step, tokens/s, peak memory and the first and
   last loss printed; then ``launch.serve --ckpt`` serves the newest
   checkpoint (``flash_attention`` on ``tc_prefill`` and ``decode``), its
   greedy tokens equal to an engine on the trained parameters in memory;
10. the mesh and the launch tooling:
   a. an NCCL process group of one and a ``(data, model) = (1, 1)`` mesh:
      ``launch.train --model-axis 1`` trains radar-lm-100m at full width
      (phase 9's data and seed, 6 steps) with its state as DTensors laid
      out by ``param_shardings``, its losses within 1e-3 of the same
      steps with no mesh, ms per step beside the unmeshed step; the
      archive prompts served with DTensor parameters through the kernel
      route, greedy tokens and launches equal to plain parameters;
   b. gradient compression over a float32 tree shaped like zamba2-1.2b's
      parameters (1 178 699 904 values): int8 and bf16 encode and decode
      and ``compress_with_feedback`` timed with the on-wire MB;
      ``compressed_psum`` through the NCCL group bitwise the codec's round
      trip; the int8 codec on the card bitwise the CPU's;
   c. ``attention_core(impl="flash_decode", n_chunks=4)`` at the decode
      shapes of deepseek-v2-lite's MLA and radar-lm against the kernel
      route's ``decode`` (its launches counted) and the blocked core, in
      float32 within 2e-5, timed;
   d. ``repro_torch.launch.dryrun`` on the H100 production meshes (fake
      process groups of 256 and 512, one process per cell, beside 10c)
      for llama3.2-1b ``train_4k``, deepseek-v2-lite-16b ``prefill_32k``
      and ``decode_32k`` and zamba2-1.2b ``long_500k``: peak bytes per
      device, FLOPs, collective bytes by kind and the roofline's dominant
      term; then llama3.2-1b ``train_4k`` at world 1, its global batch
      cut to 2: the dry run's predicted peak bytes beside
      ``torch.cuda.max_memory_allocated`` and its FLOPs over the measured
      step time.

It prints a JSON line of per-kernel numbers, the card line again, and as
its last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without a CUDA device it exits non-zero before any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent

# the main path's archive: VCP-212 at full width, cut in depth only
N_SCANS = 64                      # 4 full time chunks of 16 scans
# VCP-212's four lowest cuts (CAPPI at 2 km and column-max need them)
# and its top one; sweep 0 feeds QPE, sweep 4 (the top cut) QVP
ELEVATIONS = (0.5, 0.9, 1.3, 1.8, 19.5)
QPE_SWEEP, QVP_SWEEP = 0, 4
MOMENTS = ("DBZH", "RHOHV")
# moments kept per sweep: RHOHV only where QVP and QPE read
SWEEP_MOMENTS = {QPE_SWEEP: MOMENTS, QVP_SWEEP: MOMENTS}
N_APPEND = 1                      # scans the incremental path appends
T0 = 1305849600.0                 # 2011-05-20, the paper's KVNX case
SEED = 0
VCP_NAME = "VCP-212"
# where the paths run; a rehearsal on a machine without a card sets it
# to "cpu" and stands the plain versions in for the kernels
DEV = "cuda"

# published peaks (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s, float32 FLOP/s outside the tensor cores, and
# bfloat16 FLOP/s on the tensor cores.  Matched against the card's name in
# this order.
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100", 3.35e12, 67e12, 989e12),
    ("H200", 4.8e12, 67e12, 989e12),
)

QVP_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels.py, qvp_reduce
QPE_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py, zr_accum


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def card_peaks(name: str):
    for key, bw, flops, tc_flops in CARD_PEAKS:
        if key in name:
            return bw, flops, tc_flops
    raise RuntimeError(f"no published peaks for card {name!r}")


# -- comparisons --------------------------------------------------------------

def compare(name, got, want, *, rtol, atol) -> float:
    """Assert ``got`` ~ ``want`` (NaN where the other is NaN); returns the
    largest absolute difference over finite entries.  Computed on the card
    where either tensor is (the host's copy and scan of the large tensors
    of phase 3 took most of its time)."""
    import torch

    dev = got.device if got.device.type == "cuda" else want.device
    got = got.detach().to(dev, torch.float32)
    want = want.detach().to(dev, torch.float32)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        raise AssertionError(f"{name}: NaN masks differ in "
                             f"{int((nan_g ^ nan_w).sum())} entries")
    ok = ~nan_w
    diff = (got[ok] - want[ok]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not torch.allclose(got[ok], want[ok], rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max |diff| {err} beyond rtol={rtol} "
                             f"atol={atol}")
    return err


def bitwise_equal(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def time_cuda(fn, *, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean ms per call of ``inner`` calls,
    timed with CUDA events after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


# -- phase 3: kernel check ----------------------------------------------------

def radar_field(shape, gen, nan_frac=0.15):
    import torch

    f = torch.randn(shape, generator=gen, device=DEV) * 12.0 + 20.0
    f[torch.rand(shape, generator=gen, device=DEV) < nan_frac] = float("nan")
    return f


def check_kernels(peak_bw: float, peak_flops: float):
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    main_shape = (N_SCANS, 720, 1192)
    rows = {}

    # qvp_reduce ------------------------------------------------------------
    qvp_cases = [main_shape, (5, 37, 77), (3, 720, 1193), (1, 9, 1)]
    for shape in qvp_cases:
        field = radar_field(shape, gen)
        quality = torch.rand(shape, generator=gen, device=DEV) * 0.5 + 0.5
        got = ops.qvp_reduce(field, quality, mode="kernel")
        again = ops.qvp_reduce(field, quality, mode="kernel")
        torch.cuda.synchronize()
        if not bitwise_equal(got, again):
            raise AssertionError(f"qvp_reduce {shape}: not bitwise stable")
        err = compare(f"qvp_reduce {shape}", got,
                      ref.qvp_reduce(field, quality), **QVP_TOL)
        err_nq = compare(f"qvp_reduce {shape} no quality",
                         ops.qvp_reduce(field, None, mode="kernel"),
                         ref.qvp_reduce(field, None), **QVP_TOL)
        say(f"check qvp_reduce {shape}: max_abs_err {err:.3e} "
            f"(no quality {err_nq:.3e}), bitwise stable")
        if shape == main_shape:
            rows["qvp_reduce"] = dict(field=field, quality=quality,
                                      max_abs_err=max(err, err_nq))
    # exactly 0.1*A valid azimuths per row keep their mean (inclusive
    # comparison); one fewer gives NaN
    field = torch.full((2, 720, 33), float("nan"), device=DEV)
    field[:, :72, :] = 30.0
    got = ops.qvp_reduce(field, torch.ones_like(field), mode="kernel")
    if torch.isnan(got).any() or not torch.all(got == 30.0):
        raise AssertionError("qvp_reduce: rows with exactly 0.1*A valid "
                             "azimuths must not be NaN")
    field[:, 71, :] = float("nan")
    if not torch.isnan(ops.qvp_reduce(field, None, mode="kernel")).all():
        raise AssertionError("qvp_reduce: rows below 0.1*A must be NaN")
    say("check qvp_reduce: 72 of 720 valid azimuths kept, 71 gives NaN")

    # zr_accum --------------------------------------------------------------
    zr_cases = [main_shape, (7, 13, 301), (2, 720, 1193), (1, 1, 1)]
    for shape in zr_cases:
        dbz = radar_field(shape, gen)
        dt_s = torch.rand(shape[0], generator=gen, device=DEV) * 200 + 200
        got = ops.zr_accum(dbz, dt_s, mode="kernel")
        again = ops.zr_accum(dbz, dt_s, mode="kernel")
        torch.cuda.synchronize()
        if not bitwise_equal(got, again):
            raise AssertionError(f"zr_accum {shape}: not bitwise stable")
        err = compare(f"zr_accum {shape}", got, ref.zr_accum(dbz, dt_s),
                      **QPE_TOL)
        say(f"check zr_accum {shape}: max_abs_err {err:.3e}, bitwise stable")
        if shape == main_shape:
            rows["zr_accum"] = dict(dbz=dbz, dt_s=dt_s, max_abs_err=err)
            # planted fault: the last scan dropped from the sum
            try:
                compare("zr_accum planted fault", got,
                        ref.zr_accum(dbz[:-1], dt_s[:-1]), **QPE_TOL)
            except AssertionError as exc:
                say(f"check zr_accum: planted fault (last scan dropped) "
                    f"rejected ({exc})")
            else:
                raise AssertionError("zr_accum: the planted fault (last "
                                     "scan dropped) passed the check")
    # every 1e-4 dBZ over [-30, 80] with NaN and +-inf, one gate each, and
    # a misaligned base (the kernel's scalar path); against the plain
    # version, and the one-exponential rate against float64 arithmetic
    sweep = torch.arange(-300000, 800001, device=DEV, dtype=torch.float64)
    sweep = torch.cat([(sweep * 1e-4).float(), torch.tensor(
        [float("nan"), float("inf"), float("-inf")], device=DEV)])
    dt1 = torch.tensor([3600.0], device=DEV)
    for offset in (0, 1):
        buf = torch.empty(sweep.numel() + offset, device=DEV)
        buf[offset:] = sweep
        dbz = buf[offset:].view(1, 1, -1)
        got = ops.zr_accum(dbz, dt1, mode="kernel")
        err = compare(f"zr_accum dBZ sweep (base +{offset * 4} B)", got,
                      ref.zr_accum(dbz, dt1), **QPE_TOL)
        say(f"check zr_accum dBZ sweep [-30, 80] with NaN and +-inf, "
            f"{sweep.numel()} gates, base +{offset * 4} B: max_abs_err "
            f"{err:.3e}")
    d64 = sweep.double()
    exact = (10.0 ** (d64.clamp(5.0, 53.0) / 10.0) / 200.0) ** (1 / 1.6)
    wet = torch.isfinite(d64) & (d64 >= 5.0)
    rel = float(((got.double().flatten() - exact).abs() / exact)[wet].max())
    if not rel < 1e-5 or (got.flatten()[~wet] != 0).any():
        raise AssertionError(f"zr_accum: exp2 rate off by {rel:.3e} relative "
                             "or a dry gate not 0")
    say(f"check zr_accum: the exp2f rate within {rel:.3e} relative of float64 "
        "arithmetic at 1 h over the sweep; non-finite and < 5 dBZ give 0")
    known = ops.zr_accum(torch.full((1, 1, 1), 40.0, device=DEV),
                         torch.tensor([3600.0], device=DEV), mode="kernel")
    expected = (1e4 / 200.0) ** (1 / 1.6)
    if abs(float(known) - expected) > 1e-4 * expected:
        raise AssertionError(f"zr_accum: 40 dBZ for 1 h gave {float(known)}, "
                             f"expected {expected}")
    below = ops.zr_accum(torch.full((3, 4, 8), -5.0, device=DEV),
                         torch.full((3,), 300.0, device=DEV), mode="kernel")
    if not torch.all(below == 0.0):
        raise AssertionError("zr_accum: dBZ below 5 must accumulate 0")
    say(f"check zr_accum: 40 dBZ for 1 h = {float(known):.4f} mm, "
        "below threshold = 0")

    # times at the main-path shapes -----------------------------------------
    q = rows["qvp_reduce"]
    T, A, R = main_shape
    n = T * A * R
    q["ms"] = time_cuda(lambda: ops.qvp_reduce(q["field"], q["quality"],
                                               mode="kernel"))
    q["plain_ms"] = time_cuda(lambda: ref.qvp_reduce(q["field"], q["quality"]))
    # bytes: field + quality read once, profile written once; operations:
    # per gate 2 finiteness tests, 1 compare, 2 adds (sum, count)
    q["bytes"] = 2 * n * 4 + T * R * 4
    q["ops"] = 5 * n
    z = rows["zr_accum"]
    z["ms"] = time_cuda(lambda: ops.zr_accum(z["dbz"], z["dt_s"],
                                             mode="kernel"))
    z["plain_ms"] = time_cuda(lambda: ref.zr_accum(z["dbz"], z["dt_s"]))
    z["device_ms"] = profiled_device_ms(
        lambda: ops.zr_accum(z["dbz"], z["dt_s"], mode="kernel"),
        "zr_accum_kernel")
    z["host_us"] = host_us_per_call(
        lambda: ops.zr_accum(z["dbz"], z["dt_s"], mode="kernel"), n=200)
    # bytes: dbz and dt read once, accumulation written once; operations
    # the kernel executes per gate: clip (2), fmaf, exp2, mask (2 compares
    # and a select), multiply, add (the weight division is per scan)
    z["bytes"] = n * 4 + T * 4 + A * R * 4
    z["ops"] = 9 * n
    for name, row in rows.items():
        t_bytes = row["bytes"] / peak_bw * 1e3
        t_ops = row["ops"] / peak_flops * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        say(f"time {name} {main_shape}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: {row['bytes'] / 1e9:.3f} GB, "
            f"{row['ops'] / 1e9:.3f} Gop), "
            f"{row['bytes'] / row['ms'] / 1e6:.1f} GB/s achieved"
            + (f"; device {row['device_ms']:.4f} ms (torch.profiler), "
               f"wrapper host {row['host_us']:.2f} us per call (enqueue of "
               "200)" if row.get("device_ms") else ""))
        for key in ("field", "quality", "dbz", "dt_s"):
            row.pop(key, None)
    return rows


def bits_equal(got, want) -> bool:
    """NaN in the same places and every other value equal bit for bit.
    (A NaN's payload is not compared: the card's fmax of two NaNs gives
    its canonical NaN, the CPU's the first operand.)"""
    import torch

    got, want = got.contiguous().cpu(), want.contiguous().cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = torch.isnan(got)
    bits = torch.int16 if got.element_size() == 2 else torch.int32
    return bool(torch.equal(nan, torch.isnan(want))
                and torch.equal(got[~nan].view(bits), want[~nan].view(bits)))


def site_geometry():
    """KVNX and the archive's polar axes, as the archive stores them."""
    from repro_torch.core import fm301

    # the simulator's axes (repro_torch.etl.generator.StormSimulator.volume)
    full = fm301.VCPS[VCP_NAME]
    az = (np.arange(full.n_azimuth, dtype=np.float32) + 0.5) * (
        360.0 / full.n_azimuth)
    rng = (np.arange(full.n_gates, dtype=np.float32) + 0.5) * full.gate_m
    return fm301.SITES["KVNX"], az, rng


def grid_maps():
    """The CAPPI gather maps the grid path uses (240 x 240 default grid,
    nearest, 2 km) and a 600 x 600 IDW one (about 1 km cells over the
    298 km reach), built from the archive's geometry."""
    from repro_torch.radar import grid

    site, az, rng = site_geometry()
    elevs = [float(e) for e in ELEVATIONS]
    maps = {}
    for label, n, method in (("cappi 240x240 nearest", 240, "nearest"),
                             ("cappi 600x600 idw", 600, "idw")):
        g = grid._default_grid(site.latitude, site.longitude, rng, elevs,
                               n, n)
        maps[label] = grid._cappi_mapping(site.latitude, site.longitude,
                                          site.altitude_m, az, rng, elevs, g,
                                          method, 2000.0)
    return maps


# the share of a QPE scan's gates that are wet on the archive: about
# 764 k of 858 240 (the incremental path's appends: `cells` of each QPE
# update), the dry gates in blobs
QPE_WET = 0.89
# grid_update's kernel, by the name the profiler shows
GRID_UPDATE_KERNEL = "grid_scatter_kernel"


def storm_mask(shape, frac: float, gen):
    """A flat (A * R,) mask of the gates wet in storm cells, ``frac`` of
    them: a coarse uniform field (one value per 16 x 16 gates) upsampled
    bilinearly and cut at its (1 - frac) quantile, so wet gates come in
    blobs as rain does."""
    import torch
    import torch.nn.functional as F

    A, R = shape
    coarse = torch.rand((1, 1, A // 16 + 1, R // 16 + 1), generator=gen,
                        device=DEV)
    field = F.interpolate(coarse, size=(A, R), mode="bilinear",
                          align_corners=False).flatten()
    return field > torch.quantile(field, 1.0 - frac)


def live_sectors(gate_idx, weights, n_rows: int, n_gates: int,
                 size: int = 32) -> int:
    """The distinct ``size``-byte pieces (32: sectors) that a gather map's
    live slots (weight > 0, gate in range) read, summed over ``n_rows``
    rows of a (n_rows, n_gates) float32 field: row t starts at float
    t * n_gates, so its pieces depend on that offset modulo size / 4."""
    per = size // 4
    idx = np.asarray(gate_idx, np.int64)[np.asarray(weights) > 0]
    idx = np.where(idx < 0, idx + n_gates, idx)
    idx = idx[(idx >= 0) & (idx < n_gates)]
    offsets = np.arange(n_rows, dtype=np.int64) * n_gates % per
    return sum(int((offsets == off).sum())
               * np.unique((idx + off) // per).size
               for off in np.unique(offsets))


def check_twice(name, fn, plain):
    """Kernel twice (bitwise stable) and bitwise equal to the plain
    version; returns the result and the measured max |difference|."""
    import torch

    got, again = fn(), fn()
    sync()
    if not bitwise_equal(got, again):
        raise AssertionError(f"{name}: not bitwise stable")
    want = plain()
    if not bits_equal(got, want):
        raise AssertionError(f"{name}: differs from the plain version")
    ok = ~torch.isnan(want)
    diff = (got[ok] - want[ok]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    say(f"check {name}: bitwise equal to plain (max |diff| {err}), "
        "bitwise stable")
    return got, err


def column_max_maps():
    """The per-sweep gather maps column-max folds (240 x 240 default grid,
    nearest), built from the archive's geometry."""
    from repro_torch.radar import grid

    site, az, rng = site_geometry()
    elevs = [float(e) for e in ELEVATIONS]
    g = grid._default_grid(site.latitude, site.longitude, rng, elevs, 240,
                           240)
    return [grid.build_mapping(site.latitude, site.longitude, az, rng, e, g)
            for e in elevs]


def flush_l2():
    """A function that writes 1 GiB on the card (its L2 holds 50 MB), so
    that the call after it finds none of its inputs in L2; it runs for
    about 0.3 ms, longer than the host takes to enqueue the timed call,
    so no host time enters the call's events."""
    import torch

    buf = torch.empty(256 * 2**20, dtype=torch.float32, device=DEV)
    return lambda: buf.fill_(1.0)


def time_cuda_cold(fn, flush, *, reps: int = 15) -> float:
    """Median ms of one call made right after ``flush()``: CUDA events
    around the call alone."""
    import torch

    fn()
    flush()
    sync()
    pairs = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    sync()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def time_cuda_warm(fn, *, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean ms per call of ``inner`` calls
    back to back, timed with CUDA events behind a spin of the card long
    enough for the host to enqueue them all: the device's time with L2
    warm, whatever the wrapper's host time per call."""
    import torch

    fn()
    sync()
    samples = []
    for _ in range(reps):
        if DEV == "cuda":
            torch.cuda._sleep(int(inner * 4e5))     # ~0.2 ms a call
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def in_turns(calls, timer, rounds: int = 2):
    """{name: median ms} of ``timer(call)`` for each of ``calls`` (a dict),
    taken in turns: the order, then backwards, ``rounds`` times."""
    names = list(calls)
    samples = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            samples[n].append(timer(calls[n]))
    return {n: statistics.median(v) for n, v in samples.items()}


def map_cost(maps, T: int, n_gates: int):
    """(bytes, operations, sectors) that one grid_map call over ``maps``
    (one per sweep) and T rows must move and do: the map read once, the
    distinct 32-byte sectors of each sweep's live gates in each row (a
    gather moves a whole sector; cells that share a gate or a sector need
    it once), the (T, C) output written once; per slot a test, two
    selects, a multiply and two adds, per sweep and output a compare, a
    max and a division."""
    C, k = maps[0].gate_idx.shape
    S = len(maps)
    sectors = sum(live_sectors(m.gate_idx, m.weights, T, n_gates)
                  for m in maps)
    return (C * S * k * 8 + sectors * 32 + T * C * 4,
            T * C * S * (6 * k + 3), sectors)


def chunk_bytes(maps, T: int, n_gates: int, size: int) -> int:
    """``map_cost``'s bytes with the gathers counted in distinct
    ``size``-byte chunks in place of sectors (what the card moves if it
    fetches ``size`` bytes a miss)."""
    C, k = maps[0].gate_idx.shape
    chunks = sum(live_sectors(m.gate_idx, m.weights, T, n_gates, size)
                 for m in maps)
    return C * len(maps) * k * 8 + chunks * size + T * C * 4


def check_grid_map(peak_bw: float, peak_flops: float, gen):
    """grid_map against its plain version, bitwise and twice: the CAPPI map
    (240 x 240, nearest), a 600 x 600 IDW map, column-max's five sweeps in
    one launch, ragged maps of one and several sweeps; two planted faults
    (a sweep dropped from the fold, the cell order shifted by one) must
    fail, and rows whose output column is out of range must write
    nothing.  Then the times, L2 warm (``time_cuda_warm``: calls back to
    back behind a spin of the card, since the wrapper's host time per
    call is about the nearest map's device time) and L2 cold (CUDA events
    around one call after 1 GiB was written): each case against its
    sector bound, column-max against five one-sweep launches and the fmax
    fold, the incremental paths' one-row call, and ``torch.index_select``
    of the nearest map's gates as a yardstick.
    Returns the JSON row (the nearest CAPPI call)."""
    import torch
    from repro_torch.core import fm301
    from repro_torch.kernels import grid_map as gm
    from repro_torch.kernels import ops, ref
    from repro_torch.radar import grid

    A, R = fm301.VCPS[VCP_NAME].n_azimuth, fm301.VCPS[VCP_NAME].n_gates
    S = len(ELEVATIONS)
    sweeps = [radar_field((N_SCANS, A * R), gen) for _ in range(S)]
    stacked = torch.stack(sweeps, dim=1).reshape(N_SCANS, S * A * R)

    def on_card(maps):
        """The (C, S, k) map in grid order, as the plain version takes it."""
        return (torch.from_numpy(np.stack([m.gate_idx for m in maps], 1)).to(DEV),
                torch.from_numpy(np.stack([m.weights for m in maps], 1)).to(DEV))

    maps = grid_maps()
    cases = {label: ([stacked], [mp]) for label, mp in maps.items()}
    cases["column-max 240x240 nearest, 5 sweeps"] = (sweeps,
                                                     column_max_maps())
    main = {}
    for label, (fields, mps) in cases.items():
        width = fields[0].shape[1]
        dm = grid.device_map(mps, width, DEV)
        idx, w = on_card(mps)

        def kern(fields=fields, dm=dm):
            return ops.grid_map(fields, dm.gate_idx, dm.weights,
                                order=dm.order, mode="kernel")

        C, _, k = idx.shape
        _, err = check_twice(
            f"grid_map {label} T={N_SCANS} G={width} C={C} S={len(mps)} "
            f"k={k}, 8 x 8 tiles ({dm.order.n_live} live rows)", kern,
            lambda: ref.grid_map(fields, idx, w))
        main[label] = dict(fields=fields, maps=mps, dm=dm, idx=idx, w=w,
                           kern=kern, err=err, width=width)
    # ragged: one sweep in grid order; several in the kernel's order
    for T, g, c, ns, k in ((5, 3001, 777, 1, 1), (3, 4000, 2999, 1, 4),
                           (2, 1000, 513, 1, 11), (1, 9, 1, 1, 8),
                           (5, 3001, 777, 5, 1), (3, 4000, 2999, 3, 4),
                           (1, 1000, 513, 5, 1), (2, 1000, 513, 2, 11)):
        fs = [radar_field((T, g), gen, nan_frac=0.2) for _ in range(ns)]
        # in range, past the end (NaN) and negative (wraps once)
        idx = torch.randint(-g - 5, g + 5, (c, ns, k), generator=gen,
                            device=DEV, dtype=torch.int32)
        w = torch.rand((c, ns, k), generator=gen, device=DEV) * 2.0
        w[torch.rand((c, ns, k), generator=gen, device=DEV) < 0.3] = 0.0
        w[torch.rand((c, 1, 1), generator=gen, device=DEV)
          .expand(c, ns, k) < 0.2] = 0.0            # rows out of reach
        if ns == 1:
            check_twice(f"grid_map ragged T={T} G={g} C={c} k={k}",
                        lambda: ops.grid_map(fs[0], idx[:, 0], w[:, 0],
                                             mode="kernel"),
                        lambda: ref.grid_map(fs[0], idx[:, 0], w[:, 0]))
            continue
        order, n_live = gm.cell_order(idx.cpu().numpy(), w.cpu().numpy(), g,
                                      (1, c))
        o = torch.from_numpy(order).to(DEV)
        co = gm.CellOrder(o.to(torch.int32), n_live)
        check_twice(f"grid_map ragged T={T} G={g} C={c} S={ns} k={k}, "
                    f"kernel order ({n_live} live rows)",
                    lambda: ops.grid_map(fs, idx[o].contiguous(),
                                         w[o].contiguous(), order=co,
                                         mode="kernel"),
                    lambda: ref.grid_map(fs, idx, w))
    # an order entry out of [0, C) writes nothing (CellOrder refuses it
    # before ops.grid_map; the kernel skips it all the same)
    fs = [radar_field((5, 3001), gen, nan_frac=0.2) for _ in range(2)]
    idx = torch.randint(0, 3001, (777, 2, 4), generator=gen, device=DEV,
                        dtype=torch.int32)
    w = torch.rand((777, 2, 4), generator=gen, device=DEV)
    bad = torch.arange(777, dtype=torch.int32, device=DEV)
    bad[[3, 400, 776]] = torch.tensor([777, 2**31 - 1, -2**31],
                                      dtype=torch.int32, device=DEV)
    got = gm.grid_map_cuda(fs, idx, w, bad, 777)
    sync()
    keep = bad == torch.arange(777, dtype=torch.int32, device=DEV)
    if not bits_equal(got[:, keep], ref.grid_map(fs, idx, w)[:, keep]):
        raise AssertionError("grid_map: rows with an order entry out of "
                             "range changed another column")
    try:
        gm.CellOrder(bad, 777)
    except ValueError:
        pass
    else:
        raise AssertionError("grid_map: CellOrder took an order out of "
                             "range")
    say("check grid_map: 3 order entries out of [0, C) write nothing, the "
        "other columns bitwise; CellOrder refuses them")
    nearest = main["cappi 240x240 nearest"]
    empty = ops.grid_map(stacked[:0], nearest["idx"][:, 0],
                         nearest["w"][:, 0], mode="kernel")
    if tuple(empty.shape) != (0, nearest["idx"].shape[0]):
        raise AssertionError("grid_map: T=0 must give a (0, C) result")
    none = ops.grid_map(stacked[:2], torch.zeros((4, 0), dtype=torch.int32,
                                                 device=DEV),
                        torch.zeros((4, 0), device=DEV), mode="kernel")
    if not torch.isnan(none).all():
        raise AssertionError("grid_map: k=0 must give NaN everywhere")
    say("check grid_map: T=0 gives (0, C), k=0 gives NaN")
    # planted faults on the fused column-max
    cm = main["column-max 240x240 nearest, 5 sweeps"]
    dm = cm["dm"]
    want = ref.grid_map(cm["fields"], cm["idx"], cm["w"])
    faults = {
        "a sweep dropped from the fold": lambda: ops.grid_map(
            cm["fields"][:-1], dm.gate_idx[:, :-1].contiguous(),
            dm.weights[:, :-1].contiguous(), order=dm.order, mode="kernel"),
        "the cell order shifted by one": lambda: ops.grid_map(
            cm["fields"], dm.gate_idx, dm.weights, order=gm.CellOrder(
                torch.roll(dm.order.cells, 1), dm.order.n_live),
            mode="kernel"),
    }
    for fault, fn in faults.items():
        if bits_equal(fn(), want):
            raise AssertionError(f"grid_map: the planted fault ({fault}) "
                                 "passed")
        say(f"check grid_map: planted fault ({fault}) rejected")

    # times -------------------------------------------------------------------
    flush = flush_l2()

    def warm(fn):
        return time_cuda_warm(fn)

    def cold(fn):
        return time_cuda_cold(fn, flush)

    for label, c in main.items():
        nbytes, nops, sectors = map_cost(c["maps"], N_SCANS, c["width"])
        c["bytes"], c["ops"], c["sectors"] = nbytes, nops, sectors
        bound = max(nbytes / peak_bw, nops / peak_flops) * 1e3
        b64, b128 = (chunk_bytes(c["maps"], N_SCANS, c["width"], size)
                     / peak_bw * 1e3 for size in (64, 128))
        c["warm_ms"], c["cold_ms"] = warm(c["kern"]), cold(c["kern"])
        live = int((c["w"] > 0).sum())
        say(f"time grid_map {label} (T={N_SCANS}, {live} live slots, "
            f"{sectors // N_SCANS} distinct sectors a row): L2 warm "
            f"{c['warm_ms']:.4f} ms, L2 cold {c['cold_ms']:.4f} ms, sector "
            f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), cold at "
            f"{bound / c['cold_ms']:.0%} of it; counted in 64-byte chunks "
            f"{b64:.4f} ms, in 128-byte lines {b128:.4f} ms, warm at "
            f"{b128 / c['warm_ms']:.0%} of that")
    # column-max: one launch against five one-sweep launches and the fold
    maps5, fields5 = cm["maps"], cm["fields"]
    per_sweep = [on_card([m]) for m in maps5]

    def split(fields=fields5, per_sweep=per_sweep):
        out = None
        for f, (i, w) in zip(fields, per_sweep):
            y = ops.grid_map(f, i, w, mode="kernel")
            out = y if out is None else torch.fmax(out, y)
        return out

    got, traced = traced_kernels(split)
    if not bits_equal(got, want):
        raise AssertionError("grid_map: five launches and the fmax fold "
                             "differ from the fused launch's plain version")
    say("check grid_map: 5 launches + the fmax fold bitwise equal to the "
        "fused launch's plain version; the trace's detector sees them: "
        + count_fused("five launches", traced, S - 1))
    for kind, timer in (("warm", warm), ("cold", cold)):
        t = in_turns({"fused": cm["kern"], "split": split}, timer)
        say(f"time grid_map column-max, L2 {kind}, in turns: one launch "
            f"over 5 sweeps {t['fused']:.4f} ms, 5 launches + 4 torch.fmax "
            f"{t['split']:.4f} ms ({t['split'] / t['fused']:.2f}x)")
    # the incremental paths' call: one new row through the whole map
    one = [f[:1].contiguous() for f in fields5]

    def fused_one():
        return ops.grid_map(one, dm.gate_idx, dm.weights, order=dm.order,
                            mode="kernel")

    def split_one():
        return split(one)

    if not bits_equal(fused_one(), split_one()):
        raise AssertionError("grid_map: the one-row column-max differs from "
                             "five launches and the fmax fold")
    t = in_turns({"fused": fused_one, "split": split_one}, warm)
    say(f"time grid_map incremental column-max (T=1, {dm.order.n_live} "
        f"cells in reach, 5 sweeps), L2 warm, in turns: one launch "
        f"{t['fused']:.4f} ms, 5 launches + 4 torch.fmax "
        f"{t['split']:.4f} ms")
    # the yardstick: PyTorch's gather of the nearest map's gates (no mask,
    # no weights, no order: not the same function)
    gates = nearest["idx"][:, 0, 0].long()

    def gather():
        return torch.index_select(stacked, 1, gates)

    say(f"time torch.index_select of the nearest map's {gates.numel()} gates"
        f" (T={N_SCANS}): L2 warm {warm(gather):.4f} ms, L2 cold "
        f"{cold(gather):.4f} ms")

    kern = nearest["kern"]
    C, _, k = nearest["idx"].shape
    row = dict(max_abs_err=nearest["err"], ms=nearest["cold_ms"],
               warm_ms=nearest["warm_ms"], bytes=nearest["bytes"],
               ops=nearest["ops"])
    row["device_ms"] = profiled_device_ms(kern, "grid_map_kernel")
    row["plain_ms"] = time_cuda(lambda: ref.grid_map(
        stacked, nearest["idx"][:, 0], nearest["w"][:, 0]), reps=3, inner=2)
    row["host_us"] = host_us_per_call(kern)
    row["shape"] = (f"T={N_SCANS} G={nearest['width']} C={C} k={k}, "
                    f"{nearest['sectors'] // N_SCANS} distinct sectors a row,"
                    f" 8 x 8 tiles; the kernel's ms L2 cold, L2 warm "
                    f"{nearest['warm_ms']:.4f} ms")
    return {"grid_map": row}


def check_grid_kernels(peak_bw: float, peak_flops: float):
    """grid_map and grid_update against their plain versions, bitwise
    (grid_update also against the reference's pos-mapped function), at the
    grid and incremental paths' shapes and at ragged ones; then timed at
    the main shapes, grid_update also by the profiler and the wrapper's
    host time per call."""
    import torch
    from repro_torch.core import fm301
    from repro_torch.kernels import grid_update, ops, ref

    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    A, R = fm301.VCPS[VCP_NAME].n_azimuth, fm301.VCPS[VCP_NAME].n_gates

    rows = check_grid_map(peak_bw, peak_flops, gen)
    maps = grid_maps()

    # grid_update: the in-place scatter, against its plain version and
    # against the reference's pos-mapped function with the equivalent map
    def cells_of(mask):
        return torch.nonzero(mask).flatten().to(torch.int32)

    def max_abs_diff(got, want):
        """max |got - want|, NaN against NaN counting 0 and NaN against a
        number inf."""
        d = torch.where(torch.isnan(got) & torch.isnan(want), 0.0,
                        (got - want).abs())
        return float(torch.nan_to_num(d, nan=float("inf")).max()) \
            if d.numel() else 0.0

    cappi = maps["cappi 240x240 nearest"]
    reach = torch.from_numpy(cappi.in_reach()).to(DEV)
    main = {
        # the QPE fold: a scan's wet gates, in blobs, at the archive's
        # share, added to a non-negative accumulation
        "qpe fold": ("add",
                     torch.rand((1, A * R), generator=gen, device=DEV) * 50.0,
                     cells_of(~storm_mask((A, R), 1.0 - QPE_WET, gen))),
    }
    ragged = {
        f"ragged T={t} C={c}": (op, radar_field((t, c), gen, nan_frac=0.2),
                              cells_of(torch.rand(c, generator=gen,
                                                  device=DEV) < frac))
        for op, t, c, frac in (("set", 3, 1777, 0.5), ("add", 3, 5003, 0.1),
                               ("max", 3, 2999, 0.5), ("max", 1, 4093, 0.9),
                               ("add", 1, 777, 1.0))}
    # a 240 x 240 all-NaN grid row, set where the CAPPI map reaches
    ragged["canvas T=1 C=57600"] = (
        "set", torch.full((1, reach.numel()), float("nan"), device=DEV),
        cells_of(reach))
    edge = {"M=1 T=3": ("add", radar_field((3, 4001), gen),
                            torch.tensor([4000], dtype=torch.int32,
                                         device=DEV)),
            "M=1 T=1": ("max", radar_field((1, 9), gen),
                            torch.tensor([0], dtype=torch.int32, device=DEV)),
            "M=0 T=3": ("set", radar_field((3, 513), gen),
                            torch.zeros(0, dtype=torch.int32, device=DEV))}
    for label, (op, state, cells) in {**main, **ragged, **edge}.items():
        T, C, m = state.shape[0], state.shape[1], cells.numel()
        upd = radar_field((T, m), gen, nan_frac=0.1 if op == "max" else 0.0)
        if op != "max":
            upd = upd.abs()
        pos = torch.full((C,), -1, dtype=torch.int32, device=DEV)
        pos[cells.long()] = torch.arange(m, dtype=torch.int32, device=DEV)
        launched = grid_update.launches
        got = ops.grid_scatter_(state.clone(), upd, cells, op=op,
                                mode="kernel")
        again = ops.grid_scatter_(state.clone(), upd, cells, op=op,
                                  mode="kernel")
        launched = grid_update.launches - launched
        if DEV == "cuda":
            torch.cuda.synchronize()
        want = ref.grid_scatter_(state.clone(), upd, cells, op=op)
        oracle = ref.grid_update(state, upd, pos, op=op)
        keep = torch.ones(C, dtype=torch.bool, device=DEV)
        keep[cells.long()] = False
        if launched != (2 if m else 0):
            raise AssertionError(f"grid_update {label}: {launched} launches "
                                 f"counted for 2 calls with M={m}")
        if not bitwise_equal(got, again):
            raise AssertionError(f"grid_update {label}: not bitwise stable")
        if not (bits_equal(got, want) and bits_equal(got, oracle)):
            raise AssertionError(f"grid_update {label}: differs from the "
                                 "plain version or the pos-mapped function")
        if not torch.equal(got[:, keep].view(torch.int32),
                           state[:, keep].view(torch.int32)):
            raise AssertionError(f"grid_update {label}: untouched cells "
                                 "changed")
        err = max(max_abs_diff(got, want), max_abs_diff(got, oracle))
        say(f"check grid_update {op}, {label} (T={T} C={C} M={m}): "
            + (f"bitwise equal to plain and to the pos-mapped function (max "
               f"|diff| {err}), untouched cells bitwise (NaN included), "
               "bitwise stable, 2 launches counted"
               if m else "no launch, the state returned bitwise"))
        if label == "qpe fold":
            # planted fault: every cell shifted by one
            bad = cells + 1
            bad = bad[bad < C]
            fault = ops.grid_scatter_(state.clone(), upd[:, :bad.numel()],
                                      bad, op=op, mode="kernel")
            if bits_equal(fault, want):
                raise AssertionError("grid_update: the planted fault (cells "
                                     "shifted by one) passed")
            say("check grid_update: planted fault (cells shifted by one) "
                "rejected")
        if label in main:
            main[label] = dict(op=op, state=state, upd=upd, cells=cells,
                               max_abs_err=err)
    try:
        u = main["qpe fold"]
        ops.grid_scatter_(u["state"].clone(), u["upd"], u["cells"],
                          op="mul", mode="kernel")
    except ValueError as exc:
        say(f"check grid_update: unknown op raises ({exc})")
    else:
        raise AssertionError("grid_update: an unknown op must raise")

    # times at the main shapes ----------------------------------------------
    for label, u in main.items():
        Tu, Cu = u["state"].shape
        m = u["cells"].numel()

        def kern(u=u):
            # patches u["state"] in place: timing only
            return ops.grid_scatter_(u["state"], u["upd"], u["cells"],
                                     op=u["op"], mode="kernel")

        row = dict(max_abs_err=u["max_abs_err"])
        row["ms"] = time_cuda(kern)
        row["plain_ms"] = time_cuda(lambda: ref.grid_scatter_(
            u["state"], u["upd"], u["cells"], op=u["op"]))
        row["device_ms"] = profiled_device_ms(kern, GRID_UPDATE_KERNEL)
        row["host_us"] = host_us_per_call(kern)
        # one PyTorch call of the same function (unique cells: no two adds
        # meet); the port never calls it
        lib = (u["state"].index_add_ if u["op"] == "add"
               else u["state"].index_copy_)
        cells_l = u["cells"].long()
        row["library_ms"] = time_cuda(lambda: lib(1, cells_l, u["upd"]))
        # the cell list and the update read once, each touched state value
        # read (not for set) and written once; one combine per touched
        # element
        row["bytes"] = m * 4 + Tu * m * (8 if u["op"] == "set" else 12)
        row["ops"] = Tu * m
        row["shape"] = f"{u['op']} T={Tu} C={Cu} M={m}"
        rows[f"grid_update {label}"] = row
    for name, row in rows.items():
        t_bytes = row["bytes"] / peak_bw * 1e3
        t_ops = row["ops"] / peak_flops * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        dev_ms = row.get("device_ms")
        say(f"time {name} ({row['shape']}): kernel {row['ms']:.4f} ms (CUDA "
            "events), "
            + (f"device {dev_ms:.4f} ms (torch.profiler), wrapper host "
               f"{row['host_us']:.2f} us per call (enqueue of 1000), "
               if dev_ms is not None else "")
            + f"plain {row['plain_ms']:.4f} ms, "
            + (f"library {row['library_ms']:.4f} ms, "
               if row.get("library_ms") is not None else "")
            + f"bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']}: {row['bytes'] / 1e6:.3f} MB, "
            f"{row['ops'] / 1e9:.4f} Gop), "
            f"{row['bytes'] / (dev_ms or row['ms']) / 1e6:.1f} GB/s achieved")
        for key in ("field", "idx", "w"):
            row.pop(key, None)
    # the JSON row: the QPE fold, the incremental path's most frequent call
    rows["grid_update"] = rows.pop("grid_update qpe fold")
    return rows


# -- phase 3c: the flash-attention kernel ------------------------------------

# the LM serve path: radar-lm-100m at full width (12 layers, 12 query and 4
# KV heads of 64), 8 archive scans of 1024 tokens as prompts, 32 new tokens
# each, a 2048-long KV cache
LM_ARCH = "radar-lm-100m"
# the stablelm-3b serve path: 32 layers of 32 query and 32 KV heads of
# 80 (2560 / 32), the head dim off the powers of two the attention
# kernels take since their sub-tiles follow D
STABLELM_ARCH = "stablelm-3b"
# the DeepSeek serve path: deepseek-v2-lite-16b at full width, MLA (16
# heads of q/k width 192, v 128, a 512 + 64 latent cache) and 64 routed
# experts top-6 with 2 shared after a dense first layer; float32 at this
# many layers (the dense one and 3 MoE layers, 2.3 B parameters), bfloat16
# at full depth (27)
DEEPSEEK_ARCH = "deepseek-v2-lite-16b"
DEEPSEEK_F32_LAYERS = 4
# the xLSTM serve path: xlstm-1.3b at full width (7 mLSTM and 1 sLSTM a
# unit); float32 at one unit, bfloat16 at full depth (48 layers), whose
# recurrent prefill steps token by token: timed over this many prefills
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_PREFILLS = 1
# its warm-up generate and its traced prefills take this many prompt
# tokens: each token of its prefill is the same step, and a whole prefill
# traced (224 120 kernels) took the profiler longer than the prefill
XLSTM_PROFILE_LEN = 128
LM_PROMPTS, LM_PROMPT_LEN, LM_NEW_TOKENS, LM_MAX_LEN = 8, 1024, 32, 2048
FA_F32_TOL = dict(rtol=2e-4, atol=2e-4)    # tests/test_kernels.py:281
FA_BF16_TOL = dict(rtol=5e-2, atol=5e-2)   # tests/test_kernels.py:291
# bfloat16 is also held row by row: each output row's L2 error over that
# row's L2 norm.  The elementwise 5e-2 is as large as a late row's outputs
# (their spread is ~sqrt(e / (i + 1)), ~0.05 at row 1023), so a kernel that
# lost a few keys on late rows could pass it; against each row's own scale
# it cannot.  A right kernel differs from the plain version by one bf16
# rounding of o in each (2**-9 relative) and, on the tensor cores, by P
# rounded to bf16 before P.V (2**-9 per weight): a few 1e-3 a row.
FA_BF16_ROW_RTOL = 2e-2
# the planted fault that the row check must reject at the serve shapes:
# the last 64-key tile dropped from the rows that see it
FA_FAULT_KEYS = 64
LOGIT_TOL = 2e-3                           # tests/test_serve.py:33


def visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """Query-key pairs the end-aligned causal mask lets through: query i
    sees keys 0 .. skv - sq + i."""
    if not causal:
        return sq * skv
    return sum(min(skv, skv - sq + i + 1) for i in range(sq))


def attention_cost(b, hq, hkv, sq, skv, d, causal, itemsize):
    """(bytes, operations) the function needs: q, k, v read once, o written
    once; 2 flops for each of the d products of q.k and of p.v per pair."""
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * itemsize
    return nbytes, 4 * b * hq * d * visible_pairs(sq, skv, causal)


def sdpa(q, k, v, causal: bool):
    """One PyTorch call for the same function, the yardstick beside the
    kernel (never called by the port).  Its ``is_causal`` aligns the mask
    to the top left, so it is set only where Sq == Skv; a single query at
    the end of the keys sees them all, which is no mask."""
    from torch.nn import functional as F

    sq, skv = q.shape[2], k.shape[2]
    if causal and sq not in (1, skv):
        raise ValueError("sdpa yardstick: an end-aligned causal mask needs "
                         "Sq == Skv or Sq == 1")
    return F.scaled_dot_product_attention(q, k, v,
                                          is_causal=causal and sq == skv,
                                          enable_gqa=True)


FA_ROUTES = ("tc_prefill", "decode", "f32")
L2_BYTES = 50e6                            # the H100's L2 cache
# head dims no configuration has, checked beside the paths' ones: off the
# multiples of 16 (zero columns up to the kernel's width), above 128 (two
# column groups of v), and on the wide prefill kernel (above 192 in bf16,
# above 128 in float32: S once per query tile over k-slices of 64 columns,
# up to 512 columns of o a block; decode in passes of 256)
FA_WIDE_DIMS = (40, 72, 136, 200, 256, 288, 320, 384, 512)
# the ones also checked at stablelm's B, heads and S: 256 and the widths
# above it, which are timed there too (the wide kernel beside SDPA and its
# bound)
FA_FULL_DIMS = (256, 288, 320, 384, 512)
# a decode whose group holds more than 8 query heads (sliced over the
# grid, 8 a block): checked at these head dims and at radar-lm's B and
# head dim with 32 query heads on 2 KV heads (not re-timed)
FA_GROUP = 16
FA_GROUP_DIMS = (64, 320)


def width_note(d: int) -> str:
    """How the attention kernels cover head dim ``d``."""
    from repro_torch.kernels import flash_attention

    if d <= flash_attention.SLICED_ABOVE:
        return f"kernel width {flash_attention.kernel_dim(d)}"
    slices, per_block, blocks = flash_attention.wide_tiling(d)
    passes, _cg, _gs = flash_attention.decode_tiling(d, 1)
    return (f"a prefill's S over {slices} k-slices, computed {blocks} "
            f"time(s) a query tile, {per_block} columns of o a block; "
            f"{passes} decode passes")


def attention_width(cfg) -> int:
    """The head dim a model's attention calls give the kernel: MLA's q/k
    width (v is zero-padded to it), else ``cfg.head_dim``."""
    if cfg.mla is not None:
        return cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    return cfg.head_dim


def fa_shapes():
    """{tag: (B, Hq, Hkv, D)} of the serve paths' attention calls (MLA's
    latent expands to one key and value head per query head)."""
    from repro_torch.configs import get_any_config

    out = {}
    for tag, arch in (("lm", LM_ARCH), ("zamba2", ZAMBA_ARCH),
                      ("stablelm", STABLELM_ARCH),
                      ("deepseek", DEEPSEEK_ARCH)):
        cfg = get_any_config(arch)
        hkv = cfg.n_heads if cfg.mla is not None else cfg.n_kv_heads
        out[tag] = (LM_PROMPTS, cfg.n_heads, hkv, attention_width(cfg))
    return out


def host_us_per_call(fn, n: int = 1000) -> float:
    """The host's time to enqueue one call: ``n`` calls back to back on a
    synchronised card, the host clock stopped before the device is waited
    for (the queue holds them all)."""
    sync()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t) / n * 1e6
    sync()
    return us


def fmt_ms(ms) -> str:
    """A time in ms to 4 places, or 'not measured' for None."""
    return "not measured" if ms is None else f"{ms:.4f}"


def profiled_device_ms(fn, name: str, n: int = 20):
    """Device time per kernel whose name holds ``name``, from
    ``torch.profiler`` over ``n`` calls of one such kernel each: the mean
    over the kernels it kept (None when it kept none; a window that kept
    fewer than ``n`` is said, as an earlier mean over ``n`` read too low
    then)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if DEV != "cuda":
        return None
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        sync()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name]
    if times and len(times) != n:
        say(f"profiler: {len(times)} {name} kernels kept of {n} calls")
    return sum(times) / 1e3 / len(times) if times else None


def profiled_kernel_names(fn, tries: int = 3) -> str:
    """The device kernels one call of ``fn`` ran, by ``torch.profiler``
    (the yardstick's own kernels), most device time first; a window that
    kept no kernel (seen before, PERF.md) is tried again, ``tries`` times
    in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if DEV != "cuda":
        return "not measured (no card)"
    fn()
    sync()
    times = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                times[e.name] = times.get(e.name, 0.0) + e.device_time
        if times:
            break
    if not times:
        return (f"not measured (the profiler saw no kernel in {tries} "
                "windows)")
    return "; ".join(f"{name} {t / 1e3:.4f} ms"
                     for name, t in sorted(times.items(),
                                           key=lambda kv: -kv[1]))


def first_kernels(names: str, n: int = 3, width: int = 60) -> str:
    """The first ``n`` kernels of :func:`profiled_kernel_names`' list,
    each name cut to ``width`` characters, and how many more it named."""
    parts = names.split("; ")
    out = []
    for part in parts[:n]:
        name, sep, ms = part.rpartition(" ms")[0].rpartition(" ")
        out.append(f"{name[:width]} {ms} ms" if sep else part[:width])
    more = f"; {len(parts) - n} more" if len(parts) > n else ""
    return "; ".join(out) + more


def rejected(label: str, what: str, bad, want, tol) -> None:
    """``bad`` (what a faulty kernel would give) must fail the elementwise
    check ``tol`` against ``want``."""
    import torch

    err = float((bad.float() - want.float()).abs().max())
    if torch.allclose(bad.float(), want.float(), **tol):
        raise AssertionError(f"{label}: {what} passes the check "
                             f"(max_abs_err {err:.3e}, tolerance "
                             f"{tol['atol']})")
    say(f"check {label}, {what}: max_abs_err {err:.3e}, rejected by the "
        f"elementwise check (rtol = atol = {tol['atol']})")


def traced_kernels(run, profile_it: bool = True):
    """``(run(), (fmax_calls, names))``: the calls of ``torch.fmax`` and
    ``Tensor.fmax`` that ``run()`` made, counted by a shim around both,
    and the names of the device kernels it launched, from
    ``torch.profiler`` (None off the card, or without ``profile_it``, so
    that a timed run pays for no profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls = [0]
    fn, method = torch.fmax, torch.Tensor.fmax

    def fmax(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)

    def fmax_method(self, *a, **kw):
        calls[0] += 1
        return method(self, *a, **kw)

    torch.fmax, torch.Tensor.fmax = fmax, fmax_method
    try:
        if DEV != "cuda" or not profile_it:
            return run(), (calls[0], None)
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            result = run()
            sync()
    finally:
        torch.fmax, torch.Tensor.fmax = fn, method
    return result, (calls[0], [
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA])


def count_fused(label: str, traced, fmax: int) -> str:
    """Check ``traced_kernels``' record of a run: ``fmax`` calls of
    torch.fmax (the shim's count) and, where the profiler kept the run's
    kernels, ``fmax`` fmax kernels; returns what was seen, with the
    grid_map kernels traced (the launch counters decide their count)."""
    calls, names = traced
    if calls != fmax:
        raise AssertionError(f"{label}: {calls} torch.fmax calls, expected "
                             f"{fmax}")
    if names is None:
        return f"{calls} torch.fmax calls; kernels not traced"
    seen = (sum("grid_map_kernel" in n for n in names),
            sum("fmax" in n for n in names))
    if names and seen[1] != fmax:
        raise AssertionError(f"{label}: {seen[1]} fmax passes among "
                             f"{len(names)} traced kernels, expected {fmax}")
    return (f"{calls} torch.fmax calls; {seen[0]} grid_map kernel(s) and "
            f"{seen[1]} fmax passes traced among {len(names)} device "
            "kernels")


_SASS = {}   # library path -> its SASS lines, or why there are none


def sass_lines(lib_path):
    """A built library's SASS as ``cuobjdump -sass`` prints it (a list of
    lines, read once a run), or a string saying why it is not available."""
    from torch.utils.cpp_extension import CUDA_HOME

    key = str(lib_path)
    if key not in _SASS:
        tool = shutil.which("cuobjdump")
        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin",
                                                     "cuobjdump")):
            tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
        if not tool or not Path(lib_path).exists():
            _SASS[key] = "not available (no cuobjdump or no library)"
        else:
            out = subprocess.run([tool, "-sass", key], capture_output=True,
                                 text=True, timeout=300)
            _SASS[key] = (out.stdout.splitlines() if not out.returncode else
                          f"not available (cuobjdump exit {out.returncode})")
    return _SASS[key]


def sass_counts(lib_path) -> str:
    """Tensor-core instructions in a built library's SASS, as
    ``cuobjdump -sass`` shows them."""
    lines = sass_lines(lib_path)
    if isinstance(lines, str):
        return lines
    return (f"{sum('HGMMA' in ln for ln in lines)} HGMMA and "
            f"{sum('HMMA' in ln for ln in lines)} HMMA instructions")


# the ptxas logs of the libraries built by this run, {name: log}
BUILD_LOGS = {}


def check_wgmma_pipelined(lib: str, fragment: str) -> str:
    """Fail if a kernel of library ``lib`` whose mangled name holds
    ``fragment`` has its ``wgmma`` serialized: a ptxas note C7512 or C7518
    on it in this run's build log, or, in its SASS (``cuobjdump -sass``),
    a ``WARPGROUP.DEPBAR`` (a wait) between most two ``HGMMA`` in a row
    (a pipelined group issues its k-steps back to back); returns the
    counts."""
    from repro_torch.kernels import _cuda

    for line in BUILD_LOGS.get(lib, "").splitlines():
        if fragment in line and ("(C7512)" in line or "(C7518)" in line):
            raise AssertionError(f"{lib}: serialized wgmma: {line.strip()}")
    lines = sass_lines(_cuda.library_path(lib))
    if isinstance(lines, str):
        return "SASS " + lines
    # per kernel: HGMMA, WARPGROUP.DEPBAR, HGMMA straight after an HGMMA
    counts, cur, last = {}, None, None
    for ln in lines:
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            cur, last = (name if fragment in name else None), None
            if cur:
                counts[cur] = [0, 0, 0]
        elif cur and "HGMMA" in ln:
            counts[cur][0] += 1
            counts[cur][2] += last == "HGMMA"
            last = "HGMMA"
        elif cur and "WARPGROUP.DEPBAR" in ln:
            counts[cur][1] += 1
            last = "DEPBAR"
    if not counts:
        raise AssertionError(f"{lib}: no {fragment} in the SASS")
    for name, (hgmma, waits, chained) in counts.items():
        if hgmma == 0 or 2 * chained < hgmma:
            raise AssertionError(f"{lib} {name}: {hgmma} HGMMA, {waits} "
                                 f"WARPGROUP.DEPBAR, only {chained} HGMMA "
                                 "straight after another: serialized wgmma")
    return "; ".join(f"{name}: {h} HGMMA ({c} straight after another), {w} "
                     "WARPGROUP.DEPBAR"
                     for name, (h, w, c) in sorted(counts.items()))


@contextlib.contextmanager
def prefill_boundary(dtype, above: int):
    """Route the prefills of ``dtype`` to the wide kernel above head dim
    ``above`` for a while (``flash_attention.WIDE_PREFILL_ABOVE``)."""
    from repro_torch.kernels import flash_attention

    old = flash_attention.WIDE_PREFILL_ABOVE[dtype]
    flash_attention.WIDE_PREFILL_ABOVE[dtype] = above
    try:
        yield
    finally:
        flash_attention.WIDE_PREFILL_ABOVE[dtype] = old


def row_rel_err(got, want) -> float:
    """The largest ``|got - want| / |want|`` over output rows (L2 over the
    last dimension), in float32."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp(min=1e-30)).max())


def planted_fault(q, k, v):
    """The plain version with the last ``FA_FAULT_KEYS`` keys dropped from
    the query rows that see them (the last ``FA_FAULT_KEYS`` of a causal
    prefill, the one query of a decode): what a kernel that skipped its
    last key tile there would give."""
    from repro_torch.kernels import ref

    n = FA_FAULT_KEYS
    if q.shape[2] == 1:
        return ref.flash_attention(q, k[:, :, :-n], v[:, :, :-n])
    out = ref.flash_attention(q, k, v, causal=True)
    out[:, :, -n:] = ref.flash_attention(q[:, :, -n:], k[:, :, :-n],
                                         v[:, :, :-n], causal=False)
    return out


def check_flash_attention(peak_bw: float, peak_flops: float,
                          peak_tc: float):
    """Each flash_attention route against its plain version on the card: at
    both serve paths' prefill and decode shapes (the decode keys a strided
    prefix of a longer cache; decode also against ``ref.flash_decode`` with
    the kernel's splits), float32 at 2e-4 and bfloat16 at 5e-2, and at 24
    ragged shapes, each in both dtypes and as a one-query decode of its
    keys; twice each, bitwise equal run to run, and each call on the route
    and counter the dtype and Sq choose; bfloat16 also row by row
    (``FA_BF16_ROW_RTOL``), a check that rejects a planted fault at the
    serve shapes (``planted_fault``).  Then each route timed at both
    paths' shapes beside its plain version, SDPA and the bound, the decode
    call also by the profiler (cold L2), and the wrapper's host time per
    call; and the tensor-core instructions of the built library counted."""
    import torch
    from repro_torch.kernels import _cuda, flash_attention, ops, ref

    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    S = LM_PROMPT_LEN
    n_sm = (torch.cuda.get_device_properties(0).multi_processor_count
            if DEV == "cuda" else 132)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    errs = {r: 0.0 for r in FA_ROUTES}
    row_errs = {r: 0.0 for r in FA_ROUTES}

    def check(label, q, k, v, causal, record=None):
        which = flash_attention.route(q)
        tol = FA_F32_TOL if q.dtype == torch.float32 else FA_BF16_TOL
        before = dict(flash_attention.route_launches)
        got = ops.flash_attention(q, k, v, causal=causal, mode="kernel")
        again = ops.flash_attention(q, k, v, causal=causal, mode="kernel")
        sync()
        before[which] += 2
        if flash_attention.route_launches != before:
            raise AssertionError(f"flash_attention {label}: route counters "
                                 f"{flash_attention.route_launches}, "
                                 f"expected {before}")
        if not torch.equal(got, again):
            raise AssertionError(f"flash_attention {label}: not bitwise "
                                 "stable")
        want = ref.flash_attention(q, k, v, causal=causal)
        err = compare(f"flash_attention {label}", got, want, **tol)
        note = ""
        if which == "decode":
            n = flash_attention.decode_splits(k.shape[0] * k.shape[1],
                                              k.shape[2], n_sm)
            err = max(err, compare(f"flash_attention {label} vs flash_decode",
                                   got, ref.flash_decode(q, k, v, n), **tol))
            note = f", {n} split(s) also against ref.flash_decode"
        if which == "f32":
            pair = compare(f"flash_attention {label} vs flash_attention_pairs",
                           got, ref.flash_attention_pairs(q, k, v,
                                                          causal=causal),
                           **tol)
            note = (f", against ref.flash_attention_pairs (its roundings) "
                    f"{pair:.3e}")
        if q.dtype == torch.bfloat16:
            row = row_rel_err(got, want)
            if row > FA_BF16_ROW_RTOL:
                raise AssertionError(f"flash_attention {label}: a row's "
                                     f"relative error {row:.3e} above "
                                     f"{FA_BF16_ROW_RTOL}")
            row_errs[which] = max(row_errs[which], row)
            note += (f", row error {row:.3e} (tolerance "
                     f"{FA_BF16_ROW_RTOL})")
        errs[which] = max(errs[which], err)
        if record is not None:
            record[which] = max(record.get(which, 0.0), err)
        say(f"check flash_attention {label} [{which}]: max_abs_err "
            f"{err:.3e} (tolerance {tol['atol']}), bitwise stable{note}")
        return want

    def check_fault(label, q, k, v, want):
        # the checks must reject a kernel that drops the last key tile
        bad = planted_fault(q, k, v)
        row = row_rel_err(bad, want)
        loose = bool(torch.allclose(bad.float(), want.float(),
                                    **FA_BF16_TOL))
        if row <= FA_BF16_ROW_RTOL:
            raise AssertionError(f"flash_attention {label}: the planted "
                                 f"fault's row error {row:.3e} passes the "
                                 "row check")
        say(f"check flash_attention {label}, planted fault (the last "
            f"{FA_FAULT_KEYS} keys dropped from the rows that see them): "
            f"max_abs_err {(bad.float() - want.float()).abs().max():.3e} "
            f"({'passes' if loose else 'fails'} the elementwise "
            f"{FA_BF16_TOL['atol']}), row error {row:.3e}: rejected by the "
            f"row check ({FA_BF16_ROW_RTOL})")

    # the paths' shapes ------------------------------------------------------
    cases = {}
    for tag, (B, Hq, Hkv, D) in fa_shapes().items():
        cache_k = randn(B, Hkv, LM_MAX_LEN, D)
        cache_v = randn(B, Hkv, LM_MAX_LEN, D)
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            q = randn(B, Hq, S, D).to(dtype)
            k, v = randn(B, Hkv, S, D).to(dtype), randn(B, Hkv, S, D).to(dtype)
            label = (f"{tag} prefill {dt} B={B} Hq={Hq} Hkv={Hkv} "
                     f"Sq=Skv={S} D={D}")
            want = check(label, q, k, v, True)
            if dtype == torch.bfloat16:
                check_fault(label, q, k, v, want)
            else:
                # the float32 check must reject a dropped key tile and
                # the one-term form (hi.hi alone) of the pair products
                rejected(f"flash_attention {label}", f"planted fault (the "
                         f"last {FA_FAULT_KEYS} keys dropped from the rows "
                         "that see them)", planted_fault(q, k, v), want,
                         FA_F32_TOL)
                rejected(f"flash_attention {label}", "one-term form "
                         "(flash_attention_pairs terms=1)",
                         ref.flash_attention_pairs(q, k, v, terms=1), want,
                         FA_F32_TOL)
            cases[(tag, "prefill", dt)] = (q, k, v)
            ck, cv = cache_k.to(dtype), cache_v.to(dtype)
            for kv_len in (S + 1, S + LM_NEW_TOKENS):
                q1 = randn(B, Hq, 1, D).to(dtype)
                label = (f"{tag} decode {dt} Sq=1 kv_len={kv_len} of a "
                         f"{LM_MAX_LEN}-long cache")
                args = (q1, ck[:, :, :kv_len], cv[:, :, :kv_len])
                want = check(label, *args, True)
            if dtype == torch.bfloat16:
                check_fault(label, *args, want)
            cases[(tag, "decode", dt)] = (q1, ck, cv)
            del want
        del cache_k, cache_v
    # ragged shapes: Sq 1-130, Skv - Sq 0-140, D 16/32/64/128, both masks;
    # each in both dtypes and as a one-query decode of its keys; then 8 more
    # at the head dims off the powers of two (48, 80, 96, 112)
    rng = np.random.default_rng(SEED)
    for i in range(32):
        d = (16, 32, 64, 128)[i % 4] if i < 24 else (48, 80, 96, 112)[i % 4]
        hkv = int(rng.choice([1, 2, 4]))
        hq = hkv * int(rng.choice([1, 2, 4]))
        sq, extra = int(rng.integers(1, 131)), int(rng.integers(0, 141))
        b, causal = int(rng.integers(1, 3)), bool(i % 3)
        q, k, v = (randn(b, hq, sq, d), randn(b, hkv, sq + extra, d),
                   randn(b, hkv, sq + extra, d))
        q1 = randn(b, hq, 1, d)
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            check(f"ragged B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={sq + extra} "
                  f"D={d} causal={causal} {dt}", q.to(dtype), k.to(dtype),
                  v.to(dtype), causal)
            check(f"ragged decode B={b} Hq={hq} Hkv={hkv} Skv={sq + extra} "
                  f"D={d} {dt}", q1.to(dtype), k.to(dtype), v.to(dtype),
                  causal)

    # head dims off the multiples of 16 and above 128: ragged Sq and Skv,
    # each in both dtypes, as a prefill and as a one-query decode
    B_s, Hq_s, Hkv_s, _ = fa_shapes()["stablelm"]
    for i, d in enumerate(FA_WIDE_DIMS * 2):
        hkv = int(rng.choice([1, 2, 4]))
        hq = hkv * int(rng.choice([1, 2, 4]))
        sq, extra = int(rng.integers(2, 200)), int(rng.integers(0, 141))
        b, causal = int(rng.integers(1, 3)), bool(i % 3)
        q, k, v = (randn(b, hq, sq, d), randn(b, hkv, sq + extra, d),
                   randn(b, hkv, sq + extra, d))
        q1 = randn(b, hq, 1, d)
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            check(f"head dim B={b} Hq={hq} Hkv={hkv} Sq={sq} "
                  f"Skv={sq + extra} D={d} ({width_note(d)}) "
                  f"causal={causal} {dt}",
                  q.to(dtype), k.to(dtype), v.to(dtype), causal)
            check(f"head dim decode B={b} Hq={hq} Hkv={hkv} "
                  f"Skv={sq + extra} D={d} {dt}", q1.to(dtype), k.to(dtype),
                  v.to(dtype), causal)
    full_errs = {}     # head dim -> {route: max_abs_err} at stablelm's shape
    for d in FA_FULL_DIMS:
        cache = randn(2, B_s, Hkv_s, LM_MAX_LEN, d)
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            q = randn(B_s, Hq_s, S, d).to(dtype)
            k, v = randn(B_s, Hkv_s, S, d).to(dtype), randn(
                B_s, Hkv_s, S, d).to(dtype)
            check(f"head dim {d} prefill {dt} B={B_s} Hq={Hq_s} "
                  f"Hkv={Hkv_s} Sq=Skv={S}", q, k, v, True,
                  full_errs.setdefault(d, {}))
            if dtype == torch.bfloat16:
                q1 = randn(B_s, Hq_s, 1, d).to(dtype)
                ck, cv = cache[0].to(dtype), cache[1].to(dtype)
                check(f"head dim {d} decode {dt} Sq=1 kv_len="
                      f"{S + LM_NEW_TOKENS} of a {LM_MAX_LEN}-long cache", q1,
                      ck[:, :, :S + LM_NEW_TOKENS],
                      cv[:, :, :S + LM_NEW_TOKENS], True)
        del cache
    # a group of FA_GROUP query heads on each KV head: ragged, both dtypes,
    # then at radar-lm's B and head dim
    for d in FA_GROUP_DIMS:
        for hkv in (1, 2):
            skv = int(rng.integers(70, 1200))
            q1 = randn(2, hkv * FA_GROUP, 1, d)
            k, v = randn(2, hkv, skv, d), randn(2, hkv, skv, d)
            for dtype in (torch.float32, torch.bfloat16):
                check(f"group {FA_GROUP} decode B=2 Hq={hkv * FA_GROUP} "
                      f"Hkv={hkv} Skv={skv} D={d} ({width_note(d)}) "
                      f"{str(dtype)[6:]}", q1.to(dtype), k.to(dtype),
                      v.to(dtype), True)
    B_g, _hq, _hkv, D_g = fa_shapes()["lm"]
    Hkv_g = 2
    cache = randn(2, B_g, Hkv_g, LM_MAX_LEN, D_g).to(torch.bfloat16)
    q1 = randn(B_g, Hkv_g * FA_GROUP, 1, D_g).to(torch.bfloat16)
    check(f"group {FA_GROUP} decode bf16 B={B_g} Hq={Hkv_g * FA_GROUP} "
          f"Hkv={Hkv_g} kv_len={S + LM_NEW_TOKENS} of a {LM_MAX_LEN}-long "
          "cache", q1, cache[0][:, :, :S + LM_NEW_TOKENS],
          cache[1][:, :, :S + LM_NEW_TOKENS], True)
    del cache

    # times at the paths' shapes ---------------------------------------------
    rows = {}
    n_kv = S + LM_NEW_TOKENS
    for tag, (B, Hq, Hkv, D) in fa_shapes().items():
        for which, kind, dt in (("tc_prefill", "prefill", "bf16"),
                                ("decode", "decode", "bf16"),
                                ("f32", "prefill", "f32")):
            if (tag, kind, dt) not in cases:
                continue
            q, k, v = cases[(tag, kind, dt)]
            skv = n_kv if kind == "decode" else k.shape[2]
            pairs = [(k[:, :, :skv], v[:, :, :skv])]
            if kind == "decode":
                # a cold L2 as on the path, where each layer's cache is
                # read once a step: turn over copies that exceed it
                kb = pairs[0][0].numel() * k.element_size() * 2
                n_copies = max(1, min(16, int(-(-2 * L2_BYTES // kb))))
                pairs = [(k.clone()[:, :, :skv], v.clone()[:, :, :skv])
                         for _ in range(n_copies)]
            turns = itertools.cycle(pairs)

            def call():
                return ops.flash_attention(q, *next(turns), mode="kernel")

            def plain():
                return ref.flash_attention(q, *pairs[0])

            def library():
                return sdpa(q, *next(turns), True)

            row = {"ms": time_cuda(call),
                   "plain_ms": time_cuda(plain, reps=3, inner=3),
                   "library_ms": time_cuda(library),
                   "host_us": host_us_per_call(call)}
            if kind == "decode":
                row["device_ms"] = profiled_device_ms(call, "flash_decode")
            nbytes, nops = attention_cost(B, Hq, Hkv, q.shape[2], skv, D,
                                          True, q.element_size())
            t_bytes = nbytes / peak_bw * 1e3
            if which == "f32":
                # three bf16 products for each float32 one on the tensor
                # cores; the CUDA cores' float32 bound beside it
                peak, t_ops = peak_tc, 3 * nops / peak_tc * 1e3
                row["cuda_core_bound_ms"] = max(t_bytes,
                                                nops / peak_flops * 1e3)
                row["library_kernel"] = profiled_kernel_names(library)
                say(f"bound flash_attention [f32] {tag}: on the CUDA cores "
                    f"{row['cuda_core_bound_ms']:.4f} ms ({nops / 1e9:.2f} "
                    f"GFLOP at {peak_flops / 1e12:.0f} TFLOP/s float32, "
                    f"{nbytes / 1e6:.2f} MB); as bf16 pairs {3 * nops / 1e9:.2f}"
                    f" GFLOP at {peak_tc / 1e12:.0f} TFLOP/s; SDPA float32 ran "
                    f"{row['library_kernel']}")
            else:
                peak = peak_tc if q.dtype == torch.bfloat16 else peak_flops
                t_ops = nops / peak * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            dev_ms = row.get("device_ms")
            say(f"time flash_attention [{which}] {tag} (B={B} Hq={Hq} "
                f"Hkv={Hkv} Sq={q.shape[2]} Skv={skv} D={D} {dt}"
                + (f", {len(pairs)} caches in turn" if len(pairs) > 1
                   else "") + "): "
                f"kernel {row['ms']:.4f} ms (CUDA events, calls back to "
                "back), "
                + (f"device {dev_ms:.4f} ms (torch.profiler), "
                   if dev_ms is not None else
                   ("device not measured (the profiler saw no kernel), "
                    if kind == "decode" else ""))
                + f"plain {row['plain_ms']:.4f} ms, SDPA "
                f"{row['library_ms']:.4f} ms (kernel / SDPA "
                f"{row['ms'] / row['library_ms']:.2f}), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                f"{nbytes / 1e6:.2f} MB, "
                f"{(3 if which == 'f32' else 1) * nops / 1e9:.2f} GFLOP at "
                f"{peak / 1e12:.0f} TFLOP/s), "
                f"{nops / row['ms'] / 1e9:.1f} TFLOP/s and "
                f"{nbytes / row['ms'] / 1e6:.1f} GB/s achieved; wrapper "
                f"host {row['host_us']:.2f} us per call (enqueue of 1000); "
                f"{width_note(D)}")
            rows[(which, tag)] = row

    # the wide kernel: timed at stablelm's B, heads and S at the head dims
    # above 256, beside its plain version, SDPA and its bound ---------------
    def timed_row(which, q, k, v):
        # calls of a millisecond or more: fewer repetitions do
        row = {"ms": time_cuda(lambda: ops.flash_attention(q, k, v,
                                                           mode="kernel"),
                               reps=5, inner=5),
               "plain_ms": time_cuda(lambda: ref.flash_attention(q, k, v),
                                     reps=3, inner=1),
               "library_ms": time_cuda(lambda: sdpa(q, k, v, True), reps=5,
                                       inner=5)}
        nbytes, nops = attention_cost(*q.shape[:2], k.shape[1], q.shape[2],
                                      k.shape[2], q.shape[3], True,
                                      q.element_size())
        t_bytes = nbytes / peak_bw * 1e3
        # three bf16 products for each float32 one on the tensor cores
        t_ops = (3 if which == "f32" else 1) * nops / peak_tc * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row["tflops"] = nops / row["ms"] / 1e9
        return row

    wide = {"tc_prefill": {}, "f32": {}}
    for d in FA_FULL_DIMS:
        if d <= flash_attention.SLICED_ABOVE:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            which = "f32" if dtype == torch.float32 else "tc_prefill"
            q = randn(B_s, Hq_s, S, d).to(dtype)
            k, v = (randn(B_s, Hkv_s, S, d).to(dtype) for _ in range(2))
            row = dict(timed_row(which, q, k, v),
                       max_abs_err=full_errs[d][which])
            wide[which][f"D{d}"] = row
            say(f"time flash_attention [{which}, wide kernel] stablelm (B="
                f"{B_s} Hq={Hq_s} Hkv={Hkv_s} Sq=Skv={S} D={d} "
                f"{str(dtype)[6:]}): kernel {row['ms']:.4f} ms (CUDA "
                f"events), plain {row['plain_ms']:.4f} ms, SDPA "
                f"{row['library_ms']:.4f} ms (kernel / SDPA "
                f"{row['ms'] / row['library_ms']:.2f}), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{row['tflops']:.1f} TFLOP/s; {width_note(d)}")
            del q, k, v
    # where the wide kernel takes over at or below 256
    # (flash_attention.WIDE_PREFILL_ABOVE): it and the narrow kernel in
    # turns at deepseek's prefill (D 192) and stablelm's shape at D 256
    boundary = {"tc_prefill": {}, "f32": {}}
    for tag, d in (("deepseek", 192), ("stablelm", 256)):
        B, Hq, Hkv, _ = fa_shapes()[tag]
        for dtype in (torch.bfloat16, torch.float32):
            which = "f32" if dtype == torch.float32 else "tc_prefill"
            q = randn(B, Hq, S, d).to(dtype)
            k, v = (randn(B, Hkv, S, d).to(dtype) for _ in range(2))

            def call():
                return ops.flash_attention(q, k, v, mode="kernel")

            ms = {"narrow": [], "wide": []}
            for kind in ("narrow", "wide", "wide", "narrow"):
                with prefill_boundary(dtype, 10 ** 9 if kind == "narrow"
                                      else 0):
                    ms[kind].append(time_cuda(call))
            routed = ("wide" if d > flash_attention.WIDE_PREFILL_ABOVE[dtype]
                      else "narrow")
            row = {"narrow_ms": statistics.mean(ms["narrow"]),
                   "wide_ms": statistics.mean(ms["wide"]),
                   "library_ms": time_cuda(lambda: sdpa(q, k, v, True)),
                   "routed": routed}
            boundary[which][f"{tag}_D{d}"] = row
            faster = "wide" if row["wide_ms"] < row["narrow_ms"] else "narrow"
            say(f"time flash_attention [{which}] {tag} (B={B} Hq={Hq} "
                f"Hkv={Hkv} Sq=Skv={S} D={d} {str(dtype)[6:]}), narrow and "
                f"wide kernel in turns: narrow {ms['narrow'][0]:.4f} / "
                f"{ms['narrow'][1]:.4f} ms, wide {ms['wide'][0]:.4f} / "
                f"{ms['wide'][1]:.4f} ms, SDPA {row['library_ms']:.4f} ms; "
                f"the route takes the {routed} kernel, the {faster} one is "
                "faster here")
            del q, k, v
    if DEV == "cuda":
        say("sass flash_attention library (tc_prefill, f32 and wide "
            "kernels, all wgmma): "
            + sass_counts(_cuda.library_path("flash_attention")))
        say("sass flash_attention wide kernels, wgmma not serialized: "
            + check_wgmma_pipelined("flash_attention", "wide_prefill_kernel"))
    say("check flash_attention: worst bf16 row errors "
        + ", ".join(f"{r} {row_errs[r]:.3e}" for r in FA_ROUTES
                    if r != "f32") + f" (tolerance {FA_BF16_ROW_RTOL})")
    # the JSON rows: each route at radar-lm's shape (the zamba2, stablelm
    # and deepseek shapes' times ride along for those paths' kernel
    # shares), and the wrapper under its own name with the main path's
    # prefill route's numbers
    out = {"flash_attention": dict(rows[("tc_prefill", "lm")],
                                   max_abs_err=max(errs.values()))}
    for which in FA_ROUTES:
        row = dict(rows[(which, "lm")], max_abs_err=errs[which])
        zrow = rows[(which, "zamba2")]
        row["zamba2_ms"] = zrow["ms"]
        row["zamba2_device_ms"] = zrow.get("device_ms")
        srow = rows[(which, "stablelm")]
        row.update(stablelm_ms=srow["ms"],
                   stablelm_device_ms=srow.get("device_ms"),
                   stablelm_bound_ms=srow["bound_ms"],
                   stablelm_library_ms=srow["library_ms"])
        if which == "f32":
            row.update(zamba2_library_ms=zrow["library_ms"],
                       zamba2_bound_ms=zrow["bound_ms"],
                       zamba2_cuda_core_bound_ms=zrow["cuda_core_bound_ms"],
                       zamba2_library_kernel=zrow["library_kernel"])
        # DeepSeek's MLA at D = 192 (16 query heads, the latent expanded
        # to 16 KV heads, v zero-padded to 192)
        row["deepseek"] = {key: rows[(which, "deepseek")].get(key)
                           for key in ("ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "host_us")}
        if which in wide:
            # the wide kernel above 256 (its launches: the paths' calls that
            # took it) and the comparison that sets where it takes over
            row["wide"] = dict(wide[which], launches=0)
            row["boundary"] = boundary[which]
        out[f"flash_attention:{which}"] = row
    return out


# -- phase 3d: the mamba2_scan kernels -----------------------------------------

# the zamba2 serve path: zamba2-1.2b at full width (38 Mamba-2 layers of
# 64 heads, P = N = 64; a shared attention block of 32 query and 32 KV heads
# of 64 after every 6), the same 8 archive prompts of 1024 tokens, 32 new
# tokens each, a 2048-long KV cache
ZAMBA_ARCH = "zamba2-1.2b"
SSM_TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_kernels.py:330-331
# bf16: the kernel and its plain version take the same bf16 inputs and
# compute in float32 (chunk_tc: every float32 operand of the tensor cores
# as a bf16 pair, an error near float32's); their y differ by the order of
# the sums and by one bf16 rounding, at most one bf16 step (2**-7 of |y|);
# the state stays float32 and is held at SSM_TOL
SSM_BF16_Y_TOL = dict(rtol=1e-2, atol=1e-2)
SSM_CHUNK = 64                             # csrc/mamba2_scan.cu, kCS and kT
SSM_ROUTES = ("chunk_tc", "decode", "f32")
# (P, N) of the wide kernel's cases timed at zamba2's B, L and H: P tiled
# over the grid, and N above the old limit of 365 (B and C in slices)
SSM_TILED = ((160, 160), (256, 192), (64, 384), (64, 512))
# zamba2's bf16 prefill on the kernel routes against the same prefill with
# only the Mamba-2 scan on its plain version: last-position logits, each
# request's L2 error over its L2 norm.  The two scans' y differ in the last
# bf16 bit of some elements; each such flip is carried on through every
# later bf16 rounding, so the logits of two right scans differ by a floor
# that grows with depth.  On the CPU (tools/ssm_logits_gate.py: zamba2 cut
# to 13 layers of width 1024 over 512 tokens and to 26 of width 512 over
# 1024) the plain recurrence against the chunked form gave 1.2e-2 and
# 2.0e-2, so about 3e-2 at 38 layers; the tolerance leaves that 1.7x room.
# At random weights the Mamba-2 outputs move the logits little (all of y
# zeroed: 2.2e-2 and 3.0e-2 there), so a fault inside the recurrence (the
# carried state dropped: 2.1e-2 and 2.8e-2) is within that floor; the
# gate catches gross faults.  The planted one (SSM_LOGIT_FAULT) is what a
# kernel that formed M above the diagonal would give, each token taking
# the rest of its chunk, amplified by exp(L_t - L_s) > 1: 9.4e-2 and
# 8.0e-2 there.  Phase 3d holds the kernel itself elementwise.
SSM_LOGIT_ROW_TOL = 5e-2
SSM_LOGIT_FAULT = "mask"


def zamba_shape():
    """(B, L, H, P, N) of the zamba2 serve path's prefill scans."""
    from repro_torch.configs import get_any_config

    cfg = get_any_config(ZAMBA_ARCH)
    s = cfg.ssm
    return (LM_PROMPTS, LM_PROMPT_LEN, s.expand * cfg.d_model // s.head_dim,
            s.head_dim, s.d_state)


def ssd_cost(b, l, h, p, n, itemsize, with_h0, cs=SSM_CHUNK):
    """(bytes, operations) the scan needs: x, B, C, dt, A (and h0) read
    once, y and the final state written once; operations of the chunked
    form at the kernel's chunk length, with C.B^T once per (batch, chunk)
    and only the s <= t half of a chunk's pairs: 2 N flops a pair for
    C.B^T, 2 P a pair and head for M x, and 2 P N a token and head each
    for C h and for the state update."""
    nbytes = (2 * b * l * h * p + 2 * b * l * n) * itemsize + 4 * (
        b * l * h + h + b * h * p * n * (2 if with_h0 else 1))
    ops = 0
    for c0 in range(0, l, cs):
        c = min(cs, l - c0)
        pairs = c * (c + 1) // 2
        ops += b * (2 * pairs * n + h * (2 * pairs * p + 4 * c * p * n))
    return nbytes, ops


def ssm_fault(x, dt, A, Bm, Cm, h0, kind: str):
    """The plain version with a planted fault: at the last chunk of
    ``SSM_CHUNK`` tokens, ``"update"``, its state update skipped (the
    final state is the state before it), or ``"carry"``, the carried state
    dropped from its y (the chunk scanned from zeros); in every chunk,
    ``"mask"``, M formed above the diagonal too (y_t also takes
    exp(L_t - L_s) dt_s (C_t . B_s) x_s for the later s of its chunk).
    What a kernel with that fault would give."""
    import torch
    from repro_torch.kernels import ref

    if kind == "mask":
        y, h = ref.mamba2_scan(x, dt, A, Bm, Cm, h0=h0)
        y = y.float()
        for t0 in range(0, x.shape[1], SSM_CHUNK):
            sl = slice(t0, t0 + SSM_CHUNK)
            lc = torch.cumsum(A.float() * dt[:, sl].float(), dim=1)
            c = lc.shape[1]
            later = torch.ones((c, c), dtype=torch.bool, device=x.device)
            seg = (lc[:, :, None] - lc[:, None, :]).masked_fill(
                ~later.triu(1)[None, :, :, None], float("-inf"))
            cb = torch.einsum("btn,bsn->bts", Cm[:, sl].float(),
                              Bm[:, sl].float())
            m = torch.exp(seg) * dt[:, None, sl].float() * cb[..., None]
            y[:, sl] += torch.einsum("btsh,bshp->bthp", m, x[:, sl].float())
        return y.to(x.dtype), h
    cut = (x.shape[1] - 1) // SSM_CHUNK * SSM_CHUNK
    head = ref.mamba2_scan(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                           Cm[:, :cut], h0=h0)
    tail = (x[:, cut:], dt[:, cut:], A, Bm[:, cut:], Cm[:, cut:])
    if kind == "update":
        y_tail, _ = ref.mamba2_scan(*tail, h0=head[1])
        return torch.cat([head[0], y_tail], dim=1), head[1]
    y_tail, h_tail = ref.mamba2_scan(*tail)
    return torch.cat([head[0], y_tail], dim=1), h_tail


def check_mamba2_scan(peak_bw: float, peak_flops: float, peak_tc: float):
    """Each mamba2_scan route against its plain version (the sequential
    recurrence; chunk_tc also against ``ref.mamba2_scan_chunks``, its
    roundings) on the card: at the zamba2 path's prefill shape with and
    without a start state, float32 (``f32``) and bfloat16 (``chunk_tc``),
    at its decode shape (one token from a state, ``decode``) in both, at
    ragged lengths and widths in both, and a scan split in two halves (the
    second from the first's state) against the whole; twice each, bitwise
    equal run to run, each call on the route and counter its dtype and L
    choose.  Two planted faults must fail the checks.  Then each route
    timed at the path's shapes beside its plain version and the bound, the
    decode call also by the profiler (cold L2) with the wrapper's host time
    per call, and the tensor-core instructions of the library counted."""
    import torch
    from repro_torch.kernels import _cuda, mamba2_scan, ops, ref

    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    B, L, H, P, N = zamba_shape()

    def inputs(b, l, h, p, n, dtype, with_h0):
        # x, B and C as views of one wider last axis, as the conv output's
        # split gives them to the kernel on the path
        wide = torch.randn((b, l, h * p + 2 * n), generator=gen,
                           device=DEV).to(dtype)
        x = wide[..., :h * p].reshape(b, l, h, p)
        dt = torch.rand((b, l, h), generator=gen, device=DEV) * 0.099 + 0.001
        A = -torch.linspace(1.0, 16.0, h, device=DEV)   # -exp(A_log) at init
        h0 = (torch.randn((b, h, p, n), generator=gen, device=DEV)
              if with_h0 else None)
        return x, dt, A, wide[..., h * p:h * p + n], wide[..., h * p + n:], h0

    def run(args):
        return ops.mamba2_scan(*args[:5], h0=args[5], mode="kernel")

    def held(label, got, want, dtype):
        """(y's, the state's) largest difference, each within its
        tolerance."""
        ytol = SSM_TOL if dtype == torch.float32 else SSM_BF16_Y_TOL
        return (compare(f"mamba2_scan {label} y", got[0], want[0], **ytol),
                compare(f"mamba2_scan {label} state", got[1], want[1],
                        **SSM_TOL))

    errs = {r: 0.0 for r in mamba2_scan.route_launches}

    def check(label, args, chunks=True):
        which = mamba2_scan.route(args[0], args[3].shape[-1])
        before = dict(mamba2_scan.route_launches)
        got = run(args)
        again = run(args)
        sync()
        before[which] += 2
        if mamba2_scan.route_launches != before:
            raise AssertionError(f"mamba2_scan {label}: route counters "
                                 f"{mamba2_scan.route_launches}, expected "
                                 f"{before}")
        if not (torch.equal(got[0], again[0])
                and torch.equal(got[1], again[1])):
            raise AssertionError(f"mamba2_scan {label}: not bitwise stable")
        want = ref.mamba2_scan(*args[:5], h0=args[5])
        ey, eh = held(label, got, want, args[0].dtype)
        note = ""
        if which != "decode" and chunks:
            # the plain version with the kernel's roundings (three parts
            # for the sums over N on f32_wide)
            parts = 3 if which == "f32_wide" else 2
            cy, ch = held(f"{label} vs mamba2_scan_chunks", got,
                          ref.mamba2_scan_chunks(*args[:5], h0=args[5],
                                                 parts=parts),
                          args[0].dtype)
            note = (f", against ref.mamba2_scan_chunks (parts={parts}) y "
                    f"{cy:.3e}, state {ch:.3e}")
        errs[which] = max(errs[which], ey, eh)
        ytol = SSM_TOL if args[0].dtype == torch.float32 else SSM_BF16_Y_TOL
        say(f"check mamba2_scan {label} [{which}]: max_abs_err y {ey:.3e}, "
            f"state {eh:.3e} (tolerance rtol = atol = {ytol['atol']} for y, "
            f"{SSM_TOL['atol']} for the state), bitwise stable{note}")
        return got, want

    # the path's shapes -------------------------------------------------------
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for with_h0 in (False, True):
            args = inputs(B, L, H, P, N, dtype, with_h0)
            check(f"prefill {tag} B={B} L={L} H={H} P={P} N={N} "
                  f"h0={'given' if with_h0 else 'None'}", args)
            cases[f"prefill {tag}" + (" h0" if with_h0 else "")] = args
        args = inputs(B, 1, H, P, N, dtype, True)
        check(f"decode {tag} L=1 from a state", args)
        cases[f"decode {tag}"] = args
    # the planted faults, at the prefill from a state in both dtypes, and
    # the one-term form of the float32 route (hi.hi alone): the checks must
    # reject each
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        args = cases[f"prefill {tag} h0"]
        want = ref.mamba2_scan(*args[:5], h0=args[5])
        faults = [("the last chunk's state update skipped",
                   ssm_fault(*args, "update")),
                  ("the carried state dropped from the last chunk's y",
                   ssm_fault(*args, "carry"))]
        if dtype == torch.float32:
            faults.append(("one-term form (mamba2_scan_chunks terms=1)",
                           ref.mamba2_scan_chunks(*args[:5], h0=args[5],
                                                  terms=1)))
        for what, bad in faults:
            try:
                held(f"{tag} planted fault ({what})", bad, want, dtype)
            except AssertionError as e:
                say(f"check mamba2_scan {tag} planted fault ({what}): "
                    f"rejected: {e}")
            else:
                raise AssertionError(f"mamba2_scan {tag}: the planted fault "
                                     f"({what}) passes the checks")
        del want, faults
    # ragged lengths and widths, each in both dtypes: one token, a
    # non-multiple of the chunk, one above it, several chunks
    for l, p, n in ((1, 16, 16), (2, 72, 80), (63, 8, 16), (65, 16, 8),
                    (100, 64, 64), (300, 72, 80), (1000, 64, 64),
                    (129, 128, 128), (70, 9, 12)):
        for dtype in (torch.float32, torch.bfloat16):
            check(f"ragged B=2 L={l} H=3 P={p} N={n} {str(dtype)[6:]} from a "
                  "state", inputs(2, l, 3, p, n, dtype, True))
    def wide_bounds(p, n, itemsize, pairs):
        """(tensor-core bound, CUDA-core bound, bytes, operations) of the
        wide kernel at zamba2's B, L and H: the products at the bf16 peak,
        three bf16 products a float32 one as rows 6a and 6c count theirs
        (f32_wide's six for the sums over N not counted), or as float32
        FMAs on the CUDA cores; either beside the bytes."""
        nbytes, nops = ssd_cost(B, L, H, p, n, itemsize, True)
        t_bytes = nbytes / peak_bw * 1e3
        tc = max(t_bytes, (3 if pairs else 1) * nops / peak_tc * 1e3)
        return tc, max(t_bytes, nops / peak_flops * 1e3), nbytes, nops

    # a float32 state wider than the f32 kernel holds: the wide kernel, by
    # shape (no configuration of the repo has one)
    for l in (2, 130):
        check(f"wide B=2 L={l} H=3 P=16 N=160 float32 from a state",
              inputs(2, l, 3, 16, 160, torch.float32, True))
    # a bf16 state wider than chunk_tc holds (P or N above 128) takes the
    # wide kernel (bf16_wide), as does a one-token step wider than the
    # decode kernel's N = 256: at zamba2's B, L and H with P = 64, N = 192,
    # timed beside its plain version, and at ragged shapes
    args = inputs(B, L, H, 64, 192, torch.bfloat16, True)
    check(f"wide B={B} L={L} H={H} P=64 N=192 bfloat16 from a state", args)
    wide_ms = time_cuda(lambda: run(args), reps=3, inner=3)
    wide_plain = time_cuda(lambda: ref.mamba2_scan(*args[:5], h0=args[5]),
                           reps=2, inner=1)
    tc_bound, cc_bound, nbytes, nops = wide_bounds(64, 192, 2, False)
    say(f"time mamba2_scan [bf16_wide] B={B} L={L} H={H} P=64 N=192 bf16: "
        f"kernel {wide_ms:.4f} ms (CUDA events), plain {wide_plain:.4f} ms, "
        f"bound {tc_bound:.4f} ms ({nbytes / 1e6:.2f} MB, "
        f"{nops / 1e9:.2f} GFLOP at {peak_tc / 1e12:.0f} TFLOP/s, the "
        f"tensor cores; {cc_bound:.4f} ms on the CUDA cores)")
    del args
    for l, p, n, dtype in ((70, 136, 16, torch.bfloat16),
                           (130, 16, 192, torch.bfloat16),
                           (1, 16, 320, torch.float32),
                           (1, 16, 320, torch.bfloat16)):
        check(f"wide B=2 L={l} H=3 P={p} N={n} {str(dtype)[6:]} from a "
              "state", inputs(2, l, 3, p, n, dtype, True))
    # P tiled over the grid (kernels.mamba2_scan.wide_p_tile), B and C in
    # slices of N, the state in shared memory or (wider) in global memory,
    # ragged, in both dtypes; then at zamba2's B, L and H with P = N = 160,
    # P = 256, N = 192 and P = 64, N = 384 and 512, timed beside the plain
    # version and the tensor-core and CUDA-core bounds
    for l, p, n in ((130, 160, 160), (70, 256, 192), (1, 40, 365),
                    (65, 33, 365), (130, 64, 384), (70, 160, 512),
                    (65, 40, 3000)):
        for dtype in (torch.float32, torch.bfloat16):
            tile, resident = mamba2_scan.wide_tiling(p, n, dtype)
            check(f"P-tiled B=2 L={l} H=3 P={p} N={n} (tiles of {tile}, "
                  f"{mamba2_scan.n_slices(n)} N-slices, the state "
                  f"{'in shared' if resident else 'in global'} memory) "
                  f"{str(dtype)[6:]} from a state",
                  inputs(2, l, 3, p, n, dtype, True))
    tiled = {}
    for p, n in SSM_TILED:
        for dtype in (torch.float32, torch.bfloat16):
            args = inputs(B, L, H, p, n, dtype, True)
            tag = "f32" if dtype == torch.float32 else "bf16"
            # against the sequential recurrence only: the plain version
            # with the kernel's roundings takes many seconds a call at
            # these shapes (it is held at the ragged ones above)
            check(f"P-tiled B={B} L={L} H={H} P={p} N={n} {tag} from a "
                  "state", args, chunks=False)
            tc_bound, cc_bound, nbytes, nops = wide_bounds(
                p, n, args[0].element_size(), dtype == torch.float32)
            t_bytes = nbytes / peak_bw * 1e3
            row = {"ms": time_cuda(lambda: run(args), reps=3, inner=3),
                   "plain_ms": time_cuda(
                       lambda: ref.mamba2_scan(*args[:5], h0=args[5]),
                       reps=2, inner=1),
                   "bound_ms": tc_bound,
                   "bound_by": ("bytes" if t_bytes >= tc_bound
                                else "operations"),
                   "cuda_core_bound_ms": cc_bound,
                   "library_ms": None,
                   "p_tile": mamba2_scan.wide_p_tile(p, n),
                   "resident": mamba2_scan.wide_tiling(p, n, dtype)[1]}
            tiled[(tag, f"P{p}_N{n}")] = row
            say(f"time mamba2_scan [{mamba2_scan.route(args[0], n)}] B={B} "
                f"L={L} H={H} P={p} N={n} {tag} (tiles of {row['p_tile']} "
                f"columns, the state in "
                f"{'shared' if row['resident'] else 'global'} memory): "
                f"kernel {row['ms']:.4f} ms (CUDA events), plain "
                f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}: {nbytes / 1e6:.2f} MB, "
                f"{(3 if tag == 'f32' else 1) * nops / 1e9:.2f} GFLOP at "
                f"{peak_tc / 1e12:.0f} TFLOP/s, the tensor cores), "
                f"{row['cuda_core_bound_ms']:.4f} ms on the CUDA cores "
                f"({nops / 1e9:.2f} GFLOP at {peak_flops / 1e12:.0f} TFLOP/s "
                "float32)")
            del args
    # the state continues: two halves, the second from the first's state
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, Bm, Cm, _ = inputs(2, 512, 4, P, N, dtype, False)
        (y_all, h_all), _ = check(f"whole B=2 L=512 H=4 {str(dtype)[6:]}",
                                  (x, dt, A, Bm, Cm, None))
        y1, h1 = run((x[:, :300], dt[:, :300], A, Bm[:, :300], Cm[:, :300],
                      None))
        y2, h2 = run((x[:, 300:], dt[:, 300:], A, Bm[:, 300:], Cm[:, 300:],
                      h1))
        ey, eh = held("halves", (torch.cat([y1, y2], dim=1), h2),
                      (y_all, h_all), dtype)
        say(f"check mamba2_scan state continuation {str(dtype)[6:]} (300 + "
            f"212 tokens against 512): max_abs_err y {ey:.3e}, state "
            f"{eh:.3e}")

    # times at the path's shapes ----------------------------------------------
    timed = {}
    for which, label in (("chunk_tc", "prefill bf16 h0"),
                         ("f32", "prefill f32 h0"),
                         ("decode", "decode bf16")):
        args = cases[label]
        x, h0 = args[0], args[5]
        states = [h0]
        if which == "decode":
            # a cold L2 as on the path, where each layer's state is read
            # once a step: turn over copies whose reads exceed it twice
            n_copies = max(1, min(16, int(-(-2 * L2_BYTES // (
                h0.numel() * h0.element_size())))))
            states = [h0.clone() for _ in range(n_copies)]
        turns = itertools.cycle(states)

        def call():
            return ops.mamba2_scan(*args[:5], h0=next(turns), mode="kernel")

        row = {
            "ms": time_cuda(call),
            "plain_ms": time_cuda(lambda: ref.mamba2_scan(*args[:5], h0=h0),
                                  reps=3, inner=1),
            "library_ms": None,
        }
        if which == "decode":
            # L2 cold: 1 GiB written before each call; the states in turn
            # beside it (each call's output lands in L2 for the next)
            flush = flush_l2()
            row["device_ms"] = profiled_device_ms(
                lambda: (flush(), call()), "mamba2_decode")
            row["warm_device_ms"] = profiled_device_ms(call, "mamba2_decode")
            row["cold_ms"] = time_cuda_cold(call, flush)
            row["host_us"] = host_us_per_call(call)
            del flush
        nbytes, nops = ssd_cost(*x.shape, N, x.element_size(), h0 is not None)
        t_bytes = nbytes / peak_bw * 1e3
        if which == "f32":
            # three bf16 products for each float32 one on the tensor cores;
            # the CUDA cores' float32 bound beside it
            peak, n_ops = peak_tc, 3 * nops
            row["cuda_core_bound_ms"] = max(t_bytes, nops / peak_flops * 1e3)
            say(f"bound mamba2_scan [f32] {label}: on the CUDA cores "
                f"{row['cuda_core_bound_ms']:.4f} ms ({nops / 1e9:.2f} GFLOP "
                f"at {peak_flops / 1e12:.0f} TFLOP/s float32, "
                f"{nbytes / 1e6:.2f} MB)")
        else:
            peak = peak_tc if x.dtype == torch.bfloat16 else peak_flops
            n_ops = nops
        t_ops = n_ops / peak * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        dev_ms = row.get("device_ms")
        say(f"time mamba2_scan [{which}] {label} (B={x.shape[0]} "
            f"L={x.shape[1]} H={x.shape[2]} P={x.shape[3]} N={N}"
            + (f", {len(states)} states in turn" if len(states) > 1 else "")
            + f"): kernel {row['ms']:.4f} ms (CUDA events, calls back to "
            "back), "
            + (f"device {dev_ms:.4f} ms (torch.profiler"
               + (f", L2 cold; {fmt_ms(row['warm_device_ms'])} with the "
                  f"states in turn; events around one cold call "
                  f"{row['cold_ms']:.4f} ms" if which == "decode" else "")
               + "), "
               if dev_ms is not None else
               ("device not measured (the profiler saw no kernel), "
                if which == "decode" else ""))
            + f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
            f" ms ({row['bound_by']}: {nbytes / 1e6:.2f} MB, "
            f"{n_ops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s), "
            f"{nops / row['ms'] / 1e9:.1f} TFLOP/s and "
            f"{nbytes / row['ms'] / 1e6:.1f} GB/s achieved"
            + (f"; wrapper host {row['host_us']:.2f} us per call (enqueue "
               "of 1000)" if "host_us" in row else ""))
        timed[which] = row
    if DEV == "cuda":
        say("sass mamba2_scan library (chunk_tc, f32 and wide kernels, all "
            "wgmma): " + sass_counts(_cuda.library_path("mamba2_scan")))
        say("sass mamba2_scan wide kernels, wgmma not serialized: "
            + check_wgmma_pipelined("mamba2_scan", "wide_scan_kernel"))
    # the JSON rows: each route at the path's shapes, and the wrapper under
    # its own name with the main path's prefill route's numbers
    out = {"mamba2_scan": dict(timed["chunk_tc"],
                               max_abs_err=max(errs.values()))}
    for which in SSM_ROUTES:
        out[f"mamba2_scan:{which}"] = dict(timed[which],
                                           max_abs_err=errs[which])
    # the wide kernel beside the bf16 and float32 prefill routes (bf16_wide
    # and f32_wide: no configuration of the repo takes them)
    for which, tag in (("chunk_tc", "bf16"), ("f32", "f32")):
        out[f"mamba2_scan:{which}"]["wide_p_tiled"] = {
            shape: dict(row, max_abs_err=errs[f"{tag}_wide"])
            for (t, shape), row in tiled.items() if t == tag}
    return out


# -- phase 4: the archive and the main path -----------------------------------

def archive_volume(sim, site, vcp, i: int):
    """Scan ``i`` of the archive: the simulator volume at t0 + i * interval,
    with each sweep's moments cut to the ones the paths read."""
    vol = sim.volume(site, vcp, T0 + i * vcp.interval_s)
    for si, sw in enumerate(vol["sweeps"]):
        keep = SWEEP_MOMENTS.get(si, ("DBZH",))
        sw["moments"] = {m: sw["moments"][m] for m in keep}
    return vol


def build_archive(path: str):
    from repro_torch.core import RadarArchive, fm301
    from repro_torch.etl import StormSimulator
    from repro_torch.store import Repository

    full = fm301.VCPS[VCP_NAME]
    vcp = fm301.VCPDef(full.vcp_id, ELEVATIONS, full.n_azimuth,
                       full.n_gates, full.gate_m, full.interval_s)
    say(f"archive: VCP-212 at full width: {vcp.n_azimuth} azimuths x "
        f"{vcp.n_gates} gates at {vcp.gate_m:.0f} m, {vcp.interval_s:.0f} s "
        f"between volumes, t0 = {T0:.0f}")
    say(f"cut time: {N_SCANS} scans = {N_SCANS // 16} time chunks of 16, "
        f"{N_SCANS * vcp.interval_s / 3600:.1f} h")
    say(f"cut sweeps: {len(ELEVATIONS)} of {full.n_sweeps}, elevations "
        f"{ELEVATIONS} (sweep {QPE_SWEEP} for QPE, sweep {QVP_SWEEP} for "
        "QVP, all for CAPPI and column-max)")
    say(f"cut moments: {', '.join(MOMENTS)} of {len(fm301.MOMENTS)} on "
        f"sweeps {sorted(SWEEP_MOMENTS)}, DBZH alone on the others")
    sim = StormSimulator(seed=SEED)
    site = fm301.SITES["KVNX"]

    def volume(i):
        return archive_volume(sim, site, vcp, i)

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        volumes = list(pool.map(volume, range(N_SCANS)))
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    repo = Repository.create(path)
    archive = RadarArchive(repo)
    tx = repo.writable_session()
    tx.encode_workers = os.cpu_count() or 1
    for vol in volumes:
        archive.append_scan(vol, tx=tx, commit=False)
    sid = tx.commit(f"append {N_SCANS} scans of {vcp.name}")
    t_commit = time.perf_counter() - t
    say(f"archive: generated {N_SCANS} volumes in {t_gen:.1f} s, appended "
        f"and committed in one transaction in {t_commit:.1f} s, snapshot "
        f"{sid}")
    return archive, vcp, volumes, sim, site


def kernel_modules():
    """Each kernel's wrapper module, which holds its launch counter."""
    from repro_torch.kernels import (flash_attention, grid_map, grid_update,
                                     mamba2_scan, qvp_reduce, zr_accum)

    return {"qvp_reduce": qvp_reduce, "zr_accum": zr_accum,
            "grid_map": grid_map, "grid_update": grid_update,
            "flash_attention": flash_attention, "mamba2_scan": mamba2_scan}


# the serve paths' kernels whose wrapper splits its launches by route
ROUTED = ("flash_attention", "mamba2_scan")


def reset_launches() -> None:
    mods = kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    for mod in mods.values():
        for counter in ("route_launches", "wide_launches"):
            for which in getattr(mod, counter, ()):
                getattr(mod, counter)[which] = 0


def add_wide_launches(rows) -> None:
    """Add the wide prefill kernel's launches since the last reset to the
    rows of the routes that took it (a part of their launches)."""
    from repro_torch.kernels import flash_attention

    for which, n in flash_attention.wide_launches.items():
        if n:
            wide = rows[f"flash_attention:{which}"]["wide"]
            wide["launches"] = wide.get("launches", 0) + n


def read_launches():
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()
    return {k: m.launches for k, m in kernel_modules().items()}


def read_routes():
    """{kernel: {route: launches}} since the last reset, for the kernels
    whose wrapper has routes."""
    mods = kernel_modules()
    return {name: dict(mods[name].route_launches) for name in ROUTED}


def add_path_launches(rows, launched, routes) -> None:
    """Add a counted run's launches to the JSON rows: each kernel's, and a
    routed kernel's also by route."""
    for name, n in launched.items():
        if n:
            rows[name]["launches"] = rows[name].get("launches", 0) + n
    for name, split in routes.items():
        for which, m in split.items():
            if m:
                row = rows[f"{name}:{which}"]
                row["launches"] = row.get("launches", 0) + m
                counts = rows[name].setdefault("routes", {})
                counts[which] = counts.get(which, 0) + m


def drive_main_path(archive, vcp, volumes, rows):
    import torch
    from repro_torch.radar import (ProductRequest, compute_product,
                                   qpe_from_volumes, qvp_from_volumes)

    qvp_req = ProductRequest(kind="qvp", vcp=VCP_NAME, sweep=QVP_SWEEP)
    qpe_req = ProductRequest(kind="qpe", vcp=VCP_NAME, sweep=QPE_SWEEP)
    results = {}
    for product, req, kernel in (("qvp", qvp_req, "qvp_reduce"),
                                 ("qpe", qpe_req, "zr_accum")):
        with archive.session() as session:
            reset_launches()
            results[product] = compute_product(session, req, device=DEV)
            launched = read_launches()
        say(f"main path {product}: kernel launches {launched}")
        if launched[kernel] < 1:
            raise AssertionError(f"{product} did not launch {kernel}")
        rows[kernel]["launches"] = launched[kernel]

    qvp, qpe = results["qvp"], results["qpe"]
    if (qvp.profile.shape != (N_SCANS, vcp.n_gates)
            or qvp.profile.dtype != np.float32):
        raise AssertionError(f"QVP profile {qvp.profile.shape} "
                             f"{qvp.profile.dtype}")
    if (qpe.accum_mm.shape != (vcp.n_azimuth, vcp.n_gates)
            or not np.isfinite(qpe.accum_mm).all()
            or (qpe.accum_mm < 0).any()):
        raise AssertionError(f"QPE accumulation {qpe.accum_mm.shape} must be "
                             "finite and >= 0")
    with archive.session() as session:
        qvp_ref = compute_product(session, qvp_req.with_options(mode="ref"),
                                  device=DEV)
        qpe_ref = compute_product(session, qpe_req.with_options(mode="ref"),
                                  device=DEV)
    e1 = compare("QVP vs plain on the card", torch.from_numpy(qvp.profile),
                 torch.from_numpy(qvp_ref.profile), **QVP_TOL)
    e2 = compare("QPE vs plain on the card", torch.from_numpy(qpe.accum_mm),
                 torch.from_numpy(qpe_ref.accum_mm), **QPE_TOL)
    base_qvp = qvp_from_volumes(volumes, sweep=QVP_SWEEP)
    base_qpe = qpe_from_volumes(volumes, sweep=QPE_SWEEP)
    # tolerances of tests/test_radar_workflows.py against the baselines
    e3 = compare("QVP vs file-based baseline", torch.from_numpy(qvp.profile),
                 torch.from_numpy(base_qvp.profile), rtol=1e-4, atol=1e-4)
    e4 = compare("QPE vs file-based baseline",
                 torch.from_numpy(qpe.accum_mm),
                 torch.from_numpy(base_qpe.accum_mm), rtol=1e-3, atol=1e-4)
    if not (np.array_equal(qvp.times, base_qvp.times)
            and np.allclose(qvp.height_m, base_qvp.height_m, rtol=1e-6)
            and qpe.n_scans == base_qpe.n_scans == N_SCANS
            and abs(qpe.total_hours - base_qpe.total_hours) < 1e-9):
        raise AssertionError("product axes differ from the baselines")
    say(f"main path qvp: profile {qvp.profile.shape}, "
        f"{int(np.isnan(qvp.profile).sum())} NaN entries; max_abs_err vs "
        f"plain {e1:.3e}, vs file baseline {e3:.3e}")
    say(f"main path qpe: accum {qpe.accum_mm.shape} over "
        f"{qpe.total_hours:.3f} h, max {float(qpe.accum_mm.max()):.2f} mm; "
        f"max_abs_err vs plain {e2:.3e}, vs file baseline {e4:.3e}")


# -- phase 4b: the grid path ---------------------------------------------------

# grid_map launches per product: column-max folds its sweeps in one
GRID_LAUNCHES = {"ppi": 1, "cappi": 1, "column_max": 1}


def grid_product(session, product: str, mode: str = "auto"):
    from repro_torch.radar import (ProductRequest, compute_product,
                                   grid_sweep_from_session)

    if product == "ppi":
        return grid_sweep_from_session(session, vcp=VCP_NAME,
                                       sweep=QPE_SWEEP, mode=mode,
                                       device=DEV)
    return compute_product(session, ProductRequest(
        kind=product, vcp=VCP_NAME, mode=mode), device=DEV)


def drive_grid_path(archive, rows) -> None:
    """PPI, CAPPI and column-max at the reference's defaults (240 x 240,
    nearest, 2 km), each with the launch counters read around it and held
    bitwise against the same request on the plain version; column-max
    traced, its one grid_map kernel and no fmax pass."""
    grid_launches = 0
    for product, launches in GRID_LAUNCHES.items():
        with archive.session() as session:
            reset_launches()
            t = time.perf_counter()
            if product == "column_max":
                got, traced = traced_kernels(
                    lambda: grid_product(session, product))
            else:
                got = grid_product(session, product)
            launched = read_launches()
            wall = time.perf_counter() - t
        say(f"grid path {product}: kernel launches {launched}, "
            f"{wall * 1e3:.1f} ms, {got.chunk_fetches} chunk payloads"
            + ("; " + count_fused(product, traced, 0)
               if product == "column_max" else ""))
        if launched["grid_map"] != launches or any(
                n for k, n in launched.items() if k != "grid_map"):
            raise AssertionError(f"{product}: expected {launches} grid_map "
                                 f"launches and no other, got {launched}")
        grid_launches += launched["grid_map"]
        with archive.session() as session:
            plain = grid_product(session, product, mode="ref")
        import torch

        if not bits_equal(torch.from_numpy(got.values),
                          torch.from_numpy(plain.values)):
            raise AssertionError(f"{product}: kernel path differs from the "
                                 "plain version on the card")
        n_t, ny, nx = got.values.shape
        finite = np.isfinite(got.values)
        if (n_t, ny, nx) != (N_SCANS, 240, 240) or not finite.any() \
                or finite.all() or got.times.shape != (N_SCANS,):
            raise AssertionError(f"{product}: values {got.values.shape}, "
                                 f"{int(finite.sum())} finite")
        say(f"grid path {product}: values {got.values.shape} bitwise equal "
            f"to plain on the card, {finite.mean():.3f} of cells in reach, "
            f"max {float(np.nanmax(got.values)):.1f} dBZ, params "
            f"{got.params}")
    rows["grid_map"]["launches"] = grid_launches


# -- phase 5: end-to-end split ------------------------------------------------

def time_products(archive, read_workers: int, reps: int = 3):
    """Median over ``reps`` fresh sessions: end-to-end compute_product, and
    the same work split into its layers."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.radar import ProductRequest, compute_product
    from repro_torch.radar.qpe import _dt_weights, read_qpe_inputs
    from repro_torch.radar.qvp import read_qvp_inputs

    reqs = {"qvp": ProductRequest(kind="qvp", vcp=VCP_NAME, sweep=QVP_SWEEP),
            "qpe": ProductRequest(kind="qpe", vcp=VCP_NAME, sweep=QPE_SWEEP)}
    out = {}
    for product, req in reqs.items():
        split = {k: [] for k in ("e2e_ms", "read_ms", "h2d_ms", "kernel_ms",
                                 "d2h_ms")}
        for _ in range(reps):
            with archive.session(read_workers=read_workers) as session:
                torch.cuda.synchronize()
                t = time.perf_counter()
                compute_product(session, req, device=DEV)
                torch.cuda.synchronize()
                split["e2e_ms"].append((time.perf_counter() - t) * 1e3)
            with archive.session(read_workers=read_workers) as session:
                t0 = time.perf_counter()
                if product == "qvp":
                    inp = read_qvp_inputs(session, vcp=VCP_NAME,
                                          sweep=QVP_SWEEP)
                    host = (inp.field, inp.quality)
                else:
                    inp = read_qpe_inputs(session, vcp=VCP_NAME,
                                          sweep=QPE_SWEEP)
                    host = (inp.dbz, _dt_weights(inp.times))
                t1 = time.perf_counter()
                fetches = session.cache_stats()["chunk_fetches"]
                dev = [torch.from_numpy(h).to(DEV) for h in host]
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if product == "qvp":
                    res = ops.qvp_reduce(dev[0], dev[1])
                else:
                    res = ops.zr_accum(dev[0], dev[1])
                end.record()
                end.synchronize()
                t3 = time.perf_counter()
                res.cpu().numpy()
                t4 = time.perf_counter()
            split["read_ms"].append((t1 - t0) * 1e3)
            split["h2d_ms"].append((t2 - t1) * 1e3)
            split["kernel_ms"].append(start.elapsed_time(end))
            split["d2h_ms"].append((t4 - t3) * 1e3)
        med = {k: statistics.median(v) for k, v in split.items()}
        mb = sum(h.nbytes for h in host) / 1e6
        say(f"time {product} read_workers={read_workers}: end-to-end "
            f"{med['e2e_ms']:.1f} ms = store read+decode {med['read_ms']:.1f}"
            f" ms + host-to-device {med['h2d_ms']:.1f} ms ({mb:.0f} MB) + "
            f"kernel {med['kernel_ms']:.3f} ms + device-to-host "
            f"{med['d2h_ms']:.2f} ms (medians of {reps}); the read decoded "
            f"{fetches} chunk payloads")
        out[product] = med
    return out


def time_store_layers(archive) -> None:
    """Each product's store read taken apart, serially: the GETs of its
    chunk payloads, then their codec decode."""
    from repro_torch.store import decode_chunk

    arrays = {"qvp": [f"{VCP_NAME}/sweep_{QVP_SWEEP}/DBZH",
                      f"{VCP_NAME}/sweep_{QVP_SWEEP}/RHOHV"],
              "qpe": [f"{VCP_NAME}/sweep_{QPE_SWEEP}/DBZH"]}
    for product, paths in arrays.items():
        with archive.session() as session:
            refs = [(session.chunk_ref(path, cid), session.array(path).meta)
                    for path in paths
                    for cid in session.array(path).meta.grid.chunk_ids()]
            t0 = time.perf_counter()
            blobs = [session.get_blob(ref) for ref, _ in refs]
            t1 = time.perf_counter()
            raw = sum(decode_chunk(blob, meta.chunks, meta.dtype, meta.codec,
                                   writable=False).nbytes
                      for blob, (_, meta) in zip(blobs, refs))
            t2 = time.perf_counter()
        packed = sum(len(b) for b in blobs)
        say(f"time {product} store layers (serial): {len(refs)} chunk GETs "
            f"{(t1 - t0) * 1e3:.1f} ms for {packed / 1e6:.0f} MB stored; "
            f"{refs[0][1].codec} decode {(t2 - t1) * 1e3:.1f} ms to "
            f"{raw / 1e6:.0f} MB ({raw / (t2 - t1) / 1e6:.0f} MB/s)")


def time_grid_products(archive, read_workers: int, reps: int = 2):
    """CAPPI and column-max: median over ``reps`` fresh sessions of the end
    to end product, and the same work split into its layers."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.radar import grid

    sweeps = list(range(len(ELEVATIONS)))
    for product in ("cappi", "column_max"):
        split = {k: [] for k in ("e2e_ms", "read_ms", "h2d_ms", "kernel_ms",
                                 "kernel_dev_ms", "kernel_host_ms",
                                 "d2h_ms")}
        for _ in range(reps):
            with archive.session(read_workers=read_workers) as session:
                if DEV == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                grid_product(session, product)
                if DEV == "cuda":
                    torch.cuda.synchronize()
                split["e2e_ms"].append((time.perf_counter() - t) * 1e3)
            with archive.session(read_workers=read_workers) as session:
                lat, lon, alt = grid._site_from_root(session)
                az, rng, elevs = grid._sweep_geometry(session, VCP_NAME,
                                                      sweeps)
                g = grid._default_grid(lat, lon, rng, elevs, 240, 240)
                if product == "cappi":
                    maps = [grid._cappi_mapping(lat, lon, alt, az, rng, elevs,
                                                g, "nearest", 2000.0)]
                else:
                    maps = [grid.build_mapping(lat, lon, az, rng, e, g)
                            for e in elevs]
                t0 = time.perf_counter()
                session.prefetch([(f"{VCP_NAME}/sweep_{si}/DBZH",
                                   (slice(None),)) for si in sweeps],
                                 wait=False)
                blocks = [session.array(f"{VCP_NAME}/sweep_{si}/DBZH")[:]
                          for si in sweeps]
                if product == "cappi":
                    blocks = [np.stack(blocks, axis=1)]
                host = [grid._flat_gates(b) for b in blocks]
                t1 = time.perf_counter()
                fetches = session.cache_stats()["chunk_fetches"]
                mb = sum(h.nbytes for h in host) / 1e6
                dev = [torch.from_numpy(h).to(DEV) for h in host]
                # cached by the grid path's runs: no map is copied
                dm = grid.device_map(maps, dev[0].shape[1], dev[0].device)
                sync()
                t2 = time.perf_counter()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                res = ops.grid_map(dev, dm.gate_idx, dm.weights,
                                   order=dm.order)
                ev[1].record()
                ev[1].synchronize()
                t3 = time.perf_counter()
                res.cpu().numpy()
                t4 = time.perf_counter()
                # the same call behind a spin of the card (~1 ms): its
                # events then hold the device's time alone, and the host
                # clock its enqueue
                torch.cuda._sleep(int(2e6))
                ev[2].record()
                h = time.perf_counter()
                ops.grid_map(dev, dm.gate_idx, dm.weights, order=dm.order)
                h = time.perf_counter() - h
                ev[3].record()
                ev[3].synchronize()
            split["read_ms"].append((t1 - t0) * 1e3)
            split["h2d_ms"].append((t2 - t1) * 1e3)
            split["kernel_ms"].append(ev[0].elapsed_time(ev[1]))
            split["kernel_dev_ms"].append(ev[2].elapsed_time(ev[3]))
            split["kernel_host_ms"].append(h * 1e3)
            split["d2h_ms"].append((t4 - t3) * 1e3)
            del blocks, host, dev
        med = {k: statistics.median(v) for k, v in split.items()}
        say(f"time {product} read_workers={read_workers}: end-to-end "
            f"{med['e2e_ms']:.1f} ms = store read+decode (+stack) "
            f"{med['read_ms']:.1f} ms + host-to-device {med['h2d_ms']:.1f} ms "
            f"({mb:.0f} MB) + "
            f"kernel {med['kernel_ms']:.3f} ms (one grid_map launch over "
            f"{len(maps)} map(s); behind a spin: device "
            f"{med['kernel_dev_ms']:.4f} ms, host enqueue "
            f"{med['kernel_host_ms']:.4f} ms) + "
            f"device-to-host {med['d2h_ms']:.2f} ms (medians of {reps}); the "
            f"read decoded {fetches} chunk payloads")


# -- phase 6: the incremental path ---------------------------------------------

def drive_incremental_path(archive, vcp, sim, site, rows) -> None:
    """Incremental CAPPI, column-max and QPE built at the head, then
    ``N_APPEND`` scans appended one commit each; after each append every
    state catches up and is held bitwise against the from-scratch product
    at that head (``compute_product`` for the grids, ``streaming_qpe``
    for QPE)."""
    import torch
    from repro_torch.radar import (ProductRequest, compute_product,
                                   incremental_product, streaming_qpe)

    repo = archive.repo
    incs = {kind: incremental_product(
        repo, ProductRequest(kind=kind, vcp=VCP_NAME, sweep=QPE_SWEEP),
        device=DEV) for kind in ("cappi", "column_max", "qpe")}
    update_launches = 0
    for step in range(N_APPEND + 1):
        if step:
            i = N_SCANS + step - 1
            sid = archive.append_scan(archive_volume(sim, site, vcp, i))
            say(f"incremental: appended scan {i} at t0 + {i} x "
                f"{vcp.interval_s:.0f} s, snapshot {sid}")
        for kind, inc in incs.items():
            reset_launches()
            t = time.perf_counter()
            if kind == "column_max":
                # the fmax shim only: the update is timed, so no profiler
                rep, traced = traced_kernels(inc.update, profile_it=False)
            else:
                rep = inc.update()
            launched = read_launches()
            t_update = time.perf_counter() - t
            update_launches += launched["grid_update"]
            # one per wet scan for QPE (every simulated scan rains); the
            # grids' one grid_map launch writes whole rows
            want = rep.n_new_scans if kind == "qpe" else 0
            if launched["grid_update"] != want:
                raise AssertionError(f"incremental {kind}: "
                                     f"{launched['grid_update']} grid_update "
                                     f"launches, expected {want}")
            if rep.noop or not 0 < rep.cells_computed <= rep.cells_full:
                raise AssertionError(f"incremental {kind}: {rep}")
            if step and not rep.cells_computed < rep.cells_full:
                raise AssertionError(f"incremental {kind}: an append "
                                     f"recomputed every cell ({rep})")
            with repo.readonly_session() as session:
                f0 = session.cache_stats()["chunk_fetches"]
                t = time.perf_counter()
                if kind == "qpe":
                    full = streaming_qpe(session, vcp=VCP_NAME,
                                         sweep=QPE_SWEEP)
                else:
                    full = compute_product(session, ProductRequest(
                        kind=kind, vcp=VCP_NAME, grid=inc.read().grid),
                        device=DEV)
                if DEV == "cuda":
                    torch.cuda.synchronize()
                t_full = time.perf_counter() - t
                full_fetches = session.cache_stats()["chunk_fetches"] - f0
            state = inc.read()
            if kind == "qpe":
                same = (state.accum_mm.tobytes() == full.accum_mm.tobytes()
                        and state.n_scans == full.n_scans
                        and state.seconds == full.seconds)
            else:
                same = (bits_equal(torch.from_numpy(state.values),
                                   torch.from_numpy(full.values))
                        and state.times.tobytes() == full.times.tobytes())
            if not same:
                raise AssertionError(f"incremental {kind} at head "
                                     f"{rep.source_snapshot}: state differs "
                                     "from the from-scratch product")
            if step and rep.chunk_fetches >= full_fetches:
                raise AssertionError(f"incremental {kind}: {rep.chunk_fetches}"
                                     f" fetches, from scratch {full_fetches}")
            say(f"incremental {kind} {'append ' + str(step) if step else 'build'}"
                f": +{rep.n_new_scans} scans, cells {rep.cells_computed} of "
                f"{rep.cells_full} ({rep.cells_computed / rep.cells_full:.4f})"
                f", chunk fetches {rep.chunk_fetches} vs {full_fetches} from "
                f"scratch, launches {launched}, "
                f"update {t_update * 1e3:.1f} ms"
                f" vs from scratch {t_full * 1e3:.1f} ms; bitwise equal to "
                "from scratch")
            if launched["grid_map"] != (0 if kind == "qpe" else 1):
                raise AssertionError(f"incremental {kind}: launches "
                                     f"{launched}, expected one grid_map "
                                     "per grid update and none for QPE")
            if kind == "column_max":
                say(f"incremental column_max: "
                    + count_fused("incremental column_max", traced, 0))
        if step:
            noop = [inc.update().noop for inc in incs.values()]
            if not all(noop):
                raise AssertionError("a second update at one head must be "
                                     "a no-op")
    rows["grid_update"]["launches"] = update_launches
    say(f"incremental path: {update_launches} grid_update launches, every "
        "state bitwise equal to from scratch at every head, "
        "second updates no-ops")


# -- phase 6b: the federated path -------------------------------------------------

# the federation: KVNX's archive and two more sites of VCP-212 at its full
# width (the same five cuts), each holding KVNX's last FED_SCANS scan
# times; a Catalog over the three
FED_SITES = ("KTLX", "KICT")
FED_SCANS = 16
FED_WORKERS = (1, 3)
# the kernel each federated product launches once per repository
FED_KERNELS = {"qvp": "qvp_reduce", "qpe": "zr_accum",
               "mosaic column_max": "grid_map", "mosaic cappi": "grid_map"}


def build_federation(archive, vcp, work: str):
    """KTLX and KICT archives beside KVNX's (FED_SCANS scans each, one
    commit), and a Catalog over the three; returns (catalog, {site:
    archive}, {site: (simulator, radar site)})."""
    from repro_torch.catalog import Catalog
    from repro_torch.core import RadarArchive, fm301
    from repro_torch.etl import StormSimulator
    from repro_torch.store import Repository

    archives, sims = {"KVNX": archive}, {}
    first = N_SCANS - FED_SCANS
    for j, site_id in enumerate(FED_SITES):
        sim, site = StormSimulator(seed=SEED + 1 + j), fm301.SITES[site_id]
        sims[site_id] = (sim, site)
        t = time.perf_counter()
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            vols = list(pool.map(
                lambda i: archive_volume(sim, site, vcp, i),
                range(first, N_SCANS)))
        repo = Repository.create(os.path.join(work, site_id))
        arc = archives[site_id] = RadarArchive(repo)
        tx = repo.writable_session()
        tx.encode_workers = os.cpu_count() or 1
        for vol in vols:
            arc.append_scan(vol, tx=tx, commit=False)
        sid = tx.commit(f"append {FED_SCANS} scans of {vcp.name}")
        say(f"federation: {site_id} at ({site.latitude}, {site.longitude}): "
            f"{FED_SCANS} scans (KVNX's scans {first}-{N_SCANS - 1}) at "
            f"{vcp.n_azimuth} x {vcp.n_gates}, {len(ELEVATIONS)} cuts, "
            f"built and committed in {time.perf_counter() - t:.1f} s, "
            f"snapshot {sid}")
    catalog = Catalog.create(os.path.join(work, "catalog"))
    for rid, arc in archives.items():
        entry = catalog.register_repository(arc.repo, repo_id=rid)
        v = entry.vcps[VCP_NAME]
        say(f"catalog: {rid} {v['n_times']} scans, t {v['time_min']:.0f}-"
            f"{v['time_max']:.0f}, sweeps {sorted(v['sweeps'])}, bbox "
            + ", ".join(f"{k} {x:.3f}" for k, x in entry.bbox.items()))
    return catalog, archives, sims


# -- phase 6c: the archive served over HTTP ----------------------------------

HTTP_PRODUCT_CACHE = 256 << 20   # holds every product below (mosaic 28 MB)
HTTP_CLIENTS = 8                 # concurrent identical QVP requests
HTTP_READ_WORKERS = 8


def http_get(url: str, path: str, headers=None, timeout: float = 600.0):
    """One GET -> (status, headers, body, ms)."""
    import http.client
    from urllib.parse import urlsplit

    host = urlsplit(url)
    conn = http.client.HTTPConnection(host.hostname, host.port,
                                      timeout=timeout)
    try:
        t = time.perf_counter()
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        body = resp.read()
        ms = (time.perf_counter() - t) * 1e3
        return resp.status, dict(resp.getheaders()), body, ms
    finally:
        conn.close()


def frame_header(body: bytes) -> bytes:
    """The canonical-JSON header of an RPRD product frame."""
    import struct

    if body[:4] != b"RPRD":
        raise AssertionError("not an RPRD product frame")
    (n,) = struct.unpack(">I", body[4:8])
    return body[8:8 + n]


def served_held(kind: str, body: bytes, want_body: bytes) -> float:
    """A served body against the mode='ref' result's encoding: the same
    header bytes, QVP and QPE within the kernels' tolerances, every other
    array (axes, grids) bitwise; the largest error."""
    import torch
    from repro_torch.serve.http import decode_payload

    if frame_header(body) != frame_header(want_body):
        raise AssertionError(f"served {kind}: header differs from the "
                             "mode='ref' result's")
    _, got = decode_payload(body)
    _, want = decode_payload(want_body)
    err = 0.0
    for name, w in want.items():
        g = got[name]
        if (kind, name) == ("qvp", "profile"):
            err = max(err, compare(f"served {kind} {name}",
                                   torch.from_numpy(g.copy()),
                                   torch.from_numpy(w.copy()), **QVP_TOL))
        elif (kind, name) == ("qpe", "accum_mm"):
            err = max(err, compare(f"served {kind} {name}",
                                   torch.from_numpy(g.copy()),
                                   torch.from_numpy(w.copy()), **QPE_TOL))
        elif not bits_equal(torch.from_numpy(g.copy()),
                            torch.from_numpy(w.copy())):
            raise AssertionError(f"served {kind} {name}: not bitwise equal "
                                 "to mode='ref'")
    return err


def drive_http_path(catalog, archives, sims, vcp, rows) -> None:
    """The federation of phase 6b served by ``repro_torch.serve.http`` on
    the card: 8 concurrent identical QVP requests coalesced onto one
    computation and one ``qvp_reduce`` launch, every body bitwise the
    in-process encoding; QPE, column-max, CAPPI and the column-max mosaic
    cold then warm (a product-cache hit, no launch) and revalidated by
    ETag (304), each against mode='ref'; a chunk fetch, a query and a
    ``/watch`` that sees exactly one appended scan.  Times: the cold
    served ms beside the in-process ms of the same product, warm, 304 and
    the body's MB."""
    import json
    import threading
    import urllib.parse

    from repro_torch.catalog import query as q
    from repro_torch.radar import compute_product
    from repro_torch.serve.http import (ArchiveServer, ArchiveService,
                                        encode_product)

    service = ArchiveService(catalog, device=DEV,
                             read_workers=HTTP_READ_WORKERS,
                             product_cache_bytes=HTTP_PRODUCT_CACHE)
    server = ArchiveServer(service, workers=2 * HTTP_CLIENTS).start()
    url = server.url
    try:
        # coalescing: 8 concurrent identical QVP requests ---------------
        qvp_path = f"/products/qvp?repo=KVNX&vcp={VCP_NAME}&sweep={QVP_SWEEP}"
        bodies, statuses = [None] * HTTP_CLIENTS, [None] * HTTP_CLIENTS
        barrier = threading.Barrier(HTTP_CLIENTS)

        def hit(i):
            barrier.wait()
            statuses[i], _h, bodies[i], _ms = http_get(url, qvp_path)

        sync()
        reset_launches()
        t = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(HTTP_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        t_qvp = (time.perf_counter() - t) * 1e3
        launched = read_launches()
        if any(th.is_alive() for th in threads) or statuses != [200] * len(
                statuses):
            raise AssertionError(f"served qvp: statuses {statuses}")
        stats = service.stats()
        flight, cache = stats["product_flight"], stats["product_cache"]
        expect = {k: 1 if k == "qvp_reduce" else 0 for k in kernel_modules()}
        if (flight["computations"] != 1 or launched != expect
                or flight["total"] + cache["hits"] != HTTP_CLIENTS):
            raise AssertionError(f"served qvp: {HTTP_CLIENTS} identical "
                                 f"requests gave {flight}, cache {cache}, "
                                 f"launches {launched}")
        rows["qvp_reduce"]["launches"] += 1
        if any(b != bodies[0] for b in bodies):
            raise AssertionError("served qvp: coalesced bodies differ")
        req = service._request_for("qvp", service._product_params(
            "qvp", urllib.parse.parse_qs(qvp_path.split("?")[1])))
        with catalog.open_session("KVNX",
                                  read_workers=HTTP_READ_WORKERS) as session:
            sync()
            t = time.perf_counter()
            inproc = encode_product(compute_product(session, req,
                                                    device=DEV))
            t_in = (time.perf_counter() - t) * 1e3
            ref_body = encode_product(compute_product(
                session, req.with_options(mode="ref"), device=DEV))
        if bodies[0] != inproc:
            raise AssertionError("served qvp: body differs from the "
                                 "in-process encoding")
        err = served_held("qvp", bodies[0], ref_body)
        say(f"http qvp: {HTTP_CLIENTS} concurrent identical requests in "
            f"{t_qvp:.1f} ms: {flight['computations']} computation "
            f"({flight['total']} through the flight, {cache['hits']} cache "
            f"hits), launches {launched}; {HTTP_CLIENTS} identical bodies of "
            f"{len(bodies[0]) / 1e6:.3f} MB, bitwise equal to the in-process "
            f"encoding ({t_in:.1f} ms in process at read_workers="
            f"{HTTP_READ_WORKERS}); header equal to mode='ref', max_abs_err "
            f"{err:.3e}")

        # other products: cold, warm, 304 --------------------------------
        grid_q = "ny=240&nx=240"
        products = {
            "qpe": (f"/products/qpe?repo=KVNX&vcp={VCP_NAME}"
                    f"&sweep={QPE_SWEEP}", "zr_accum", 1),
            "column_max": (f"/products/column_max?repo=KVNX&vcp={VCP_NAME}"
                           f"&{grid_q}", "grid_map", 1),
            "cappi": (f"/products/cappi?repo=KVNX&vcp={VCP_NAME}&{grid_q}"
                      "&altitude_m=2000", "grid_map", 1),
            "mosaic": (f"/products/mosaic?product=column_max&{grid_q}",
                       "grid_map", len(archives)),
        }
        for kind, (path, kernel, n_launch) in products.items():
            # a tenant of its own: a cold session, as a new client's
            tenant = {"X-Tenant": f"cold-{kind.replace('_', '-')}"}
            sync()
            reset_launches()
            status, headers, body, t_cold = http_get(url, path, tenant)
            launched = read_launches()
            expect = {k: n_launch if k == kernel else 0
                      for k in kernel_modules()}
            if status != 200 or launched != expect:
                raise AssertionError(f"served {kind}: status {status}, "
                                     f"launches {launched}, expected "
                                     f"{expect}: {body[:200]!r}")
            rows[kernel]["launches"] += n_launch
            reset_launches()
            status, _h, warm, t_warm = http_get(url, path, tenant)
            launched = read_launches()
            hits = service.stats()["product_cache"]["hits"]
            if (status != 200 or warm != body or any(launched.values())):
                raise AssertionError(f"served {kind} warm: status {status}, "
                                     f"launches {launched}")
            status, _h, empty, t_304 = http_get(
                url, path, {**tenant, "If-None-Match": headers["ETag"]})
            if status != 304 or empty:
                raise AssertionError(f"served {kind}: If-None-Match gave "
                                     f"{status}")
            clean = service._product_params(
                kind, urllib.parse.parse_qs(path.split("?")[1]))
            req = service._request_for(kind, clean)
            sync()
            if kind == "mosaic":
                t = time.perf_counter()
                inproc = encode_product(compute_product(
                    catalog, req, device=DEV,
                    read_workers=HTTP_READ_WORKERS))
                t_in = (time.perf_counter() - t) * 1e3
                ref_body = encode_product(compute_product(
                    catalog, req.with_options(mode="ref"), device=DEV,
                    read_workers=HTTP_READ_WORKERS))
            else:
                with catalog.open_session(
                        "KVNX", read_workers=HTTP_READ_WORKERS) as session:
                    t = time.perf_counter()
                    inproc = encode_product(compute_product(session, req,
                                                            device=DEV))
                    t_in = (time.perf_counter() - t) * 1e3
                    ref_body = encode_product(compute_product(
                        session, req.with_options(mode="ref"), device=DEV))
            if body != inproc:
                raise AssertionError(f"served {kind}: body differs from the "
                                     "in-process encoding")
            err = served_held(kind, body, ref_body)
            say(f"http {kind}: cold {t_cold:.1f} ms served (in process "
                f"{t_in:.1f} ms at read_workers={HTTP_READ_WORKERS}), warm "
                f"{t_warm:.2f} ms (product-cache hit {hits}, no launch), "
                f"304 {t_304:.2f} ms; body {len(body) / 1e6:.3f} MB bitwise "
                "equal to the in-process encoding; header equal to "
                "mode='ref', "
                + (f"max_abs_err {err:.3e}" if kind == "qpe"
                   else "grids bitwise"))

        # chunks, queries, watch -------------------------------------------
        status, _h, body, t_q = http_get(
            url, f"/query?repos=KVNX&moment=DBZH&sweep={QVP_SWEEP}"
                 "&value_gt=45&refs=1")
        doc = json.loads(body)
        want = q.query(catalog, q.moment("DBZH"), q.sweep(QVP_SWEEP),
                       q.value_gt(45.0), repos=["KVNX"])
        if (status != 200 or doc["n_matches"] != want.n_matches
                or doc["chunks_read"] != want.chunks_read):
            raise AssertionError(f"served query: {status} {doc.get('n_matches')}"
                                 f"/{doc.get('chunks_read')} against "
                                 f"{want.n_matches}/{want.chunks_read}")
        refs = [r for s_ in doc["scans"] for r in s_.get("chunk_refs", [])]
        status, headers, blob, t_c = http_get(url,
                                              f"/chunks/{refs[0]}?repo=KVNX")
        with catalog.open_session("KVNX") as session:
            stored = bytes(session.get_blob(refs[0]))
        if status != 200 or blob != stored or headers["ETag"] != \
                f'"{refs[0]}"':
            raise AssertionError("served chunk differs from the stored CAS "
                                 "blob")
        say(f"http query (KVNX sweep {QVP_SWEEP} DBZH > 45 dBZ): "
            f"{doc['n_matches']} matches, {doc['chunks_read']} chunks read, "
            f"pruning ratio {doc['pruning_ratio']:.3f}, equal to the "
            f"in-process plan, {t_q:.1f} ms; chunk {refs[0][:12]}... "
            f"({len(blob) / 1e6:.3f} MB) equal to the stored blob, "
            f"{t_c:.2f} ms")
        status, _h, body, _ms = http_get(url, "/watch")
        boot = json.loads(body)
        if status != 200 or sorted(c["repo_id"] for c in boot["changes"]) \
                != sorted(archives):
            raise AssertionError(f"served watch bootstrap: {boot}")
        cursor = urllib.parse.quote(json.dumps(boot["cursor"]))
        sid = archives["KTLX"].append_scan(archive_volume(
            *sims["KTLX"], vcp, N_SCANS + 1))
        status, _h, body, t_w = http_get(
            url, f"/watch?cursor={cursor}&timeout_s=60&poll_interval_s=0.05")
        woke = json.loads(body)
        if (status != 200 or woke["timed_out"] or woke["changes"] != [
                {"repo_id": "KTLX", "snapshot_id": sid,
                 "prev": boot["cursor"]["KTLX"]}]):
            raise AssertionError(f"served watch: {woke}")
        say(f"http watch: bootstrap {len(boot['changes'])} repositories; "
            f"after one scan appended to KTLX ({sid}) exactly that change, "
            f"{t_w:.1f} ms")
    finally:
        server.close()
        service.close()


# -- phase 6d: store maintenance at full width ---------------------------------

# the timeseries profile at a 64 MB budget: the archive's 16-scan chunks
# (11.8 MB) already exceed the default 8 MB one, which plans them as they
# are; 64 MB plans one tall time chunk of the whole series
MAINT_TARGET_BYTES = 64 << 20
REMOTE_RTT_S = 0.05


def store_bytes(root: str):
    """(objects, bytes) under a local store's root."""
    n = size = 0
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            n += 1
            size += os.path.getsize(os.path.join(dirpath, name))
    return n, size


def drive_maintenance_path(archive, rows) -> None:
    """KVNX's repository maintained at full width: the head tagged, sweep
    4's DBZH and RHOHV compacted into one tall time chunk, the QVP at the
    compacted head bitwise the QVP before with fewer chunk payloads
    decoded; history shows the compaction, a rollback to the tag gives the
    old snapshot back, and gc(keep_history=False) after the tag is
    deleted sweeps what only the compaction and the expired history held.
    Then the QVP read through a SimulatedLatencyStore (50 ms a round
    trip) at read_workers 1 and 8, bitwise the local read."""
    from repro_torch.radar import ProductRequest, compute_product
    from repro_torch.store import (CompactionProfile, ObjectStore,
                                   Repository, SimulatedLatencyStore, compact)

    repo = archive.repo
    req = ProductRequest(kind="qvp", vcp=VCP_NAME, sweep=QVP_SWEEP)

    def qvp_at(repo_, workers):
        sync()
        t = time.perf_counter()
        with repo_.readonly_session(read_workers=workers) as session:
            reset_launches()
            res = compute_product(session, req, device=DEV)
            launched = read_launches()
            fetched = session.cache_stats()["chunk_fetches"]
        ms = (time.perf_counter() - t) * 1e3
        if launched["qvp_reduce"] != 1:
            raise AssertionError(f"maintenance qvp: launches {launched}")
        rows["qvp_reduce"]["launches"] += 1
        return res, fetched, ms

    def same(a, b) -> bool:
        return (a.profile.tobytes() == b.profile.tobytes()
                and a.times.tobytes() == b.times.tobytes()
                and a.height_m.tobytes() == b.height_m.tobytes())

    head = repo.branch_head()
    repo.tag("pre-compact", head)
    before, f0, ms0 = qvp_at(repo, HTTP_READ_WORKERS)
    paths = [f"{VCP_NAME}/sweep_{QVP_SWEEP}/{m}" for m in MOMENTS]
    profile = CompactionProfile("timeseries",
                                target_chunk_bytes=MAINT_TARGET_BYTES)
    t = time.perf_counter()
    report = compact(repo, profile, paths=paths,
                     read_workers=HTTP_READ_WORKERS)
    t_compact = (time.perf_counter() - t) * 1e3
    if not report.committed or sorted(a.path for a in report.arrays) != \
            sorted(paths):
        raise AssertionError(f"compaction: {report}")
    after, f1, ms1 = qvp_at(repo, HTTP_READ_WORKERS)
    if not same(after, before) or f1 >= f0:
        raise AssertionError(f"compacted QVP: bitwise {same(after, before)},"
                             f" chunk payloads {f1} against {f0}")
    say(f"maintenance compact: {', '.join(paths)} from chunks "
        f"{report.arrays[0].chunks_before} to {report.arrays[0].chunks_after}"
        f" ({report.n_chunks_before} chunk objects to "
        f"{report.n_chunks_after}) in {t_compact:.1f} ms at read_workers="
        f"{HTTP_READ_WORKERS}, snapshot {report.snapshot_id}; QVP at the "
        f"compacted head bitwise equal to the QVP before: {ms1:.1f} ms, "
        f"{f1} chunk payloads decoded, against {ms0:.1f} ms and {f0}")
    infos = list(itertools.islice(repo.history(), 2))
    if (infos[0].snapshot_id != report.snapshot_id
            or infos[0].parent_id != head
            or not infos[0].message.startswith("compact")):
        raise AssertionError(f"history: {infos}")
    repo.rollback("main", repo.tag_head("pre-compact"))
    if repo.branch_head() != head:
        raise AssertionError("rollback did not give the tagged head back")
    repo.store.delete(repo._tag_key("pre-compact"))
    objs0, bytes0 = store_bytes(repo.store.root)
    t = time.perf_counter()
    removed = repo.gc(grace_seconds=0, keep_history=False)
    t_gc = (time.perf_counter() - t) * 1e3
    objs1, bytes1 = store_bytes(repo.store.root)
    back, _f, _ms = qvp_at(repo, HTTP_READ_WORKERS)
    if not same(back, before) or removed["chunks"] < 1:
        raise AssertionError(f"gc: removed {removed}, QVP bitwise "
                             f"{same(back, before)}")
    say(f"maintenance history: {infos[0].message!r} on {infos[1].message!r}"
        f"; rollback to the tag gave {head} back; gc(keep_history=False) "
        f"after the tag was deleted, {t_gc:.1f} ms: removed {removed}, "
        f"{objs0 - objs1} objects and {(bytes0 - bytes1) / 1e6:.1f} MB "
        f"({objs0} objects, {bytes0 / 1e6:.1f} MB before); the QVP at the "
        "head still bitwise")

    for workers in (1, HTTP_READ_WORKERS):
        sim = SimulatedLatencyStore(ObjectStore(repo.store.root),
                                    rtt_s=REMOTE_RTT_S)
        remote, fetched, ms = qvp_at(Repository.open(sim), workers)
        st = sim.stats()
        if not same(remote, before):
            raise AssertionError(f"remote QVP at read_workers={workers}: "
                                 "not bitwise the local read")
        say(f"maintenance remote read (SimulatedLatencyStore, rtt "
            f"{REMOTE_RTT_S * 1e3:.0f} ms, {sim.bandwidth_bps / 1e6:.0f} "
            f"MB/s) QVP at read_workers={workers}: {ms:.1f} ms, "
            f"{st['get_requests']} GET round trips for {st['keys_fetched']} "
            f"objects ({st['coalesce_keys_per_get']:.2f} a trip), "
            f"{st['bytes_fetched'] / 1e6:.1f} MB, {st['meta_requests']} "
            f"metadata trips, {st['simulated_s']:.2f} s simulated; "
            f"{fetched} chunk payloads decoded; bitwise the local read "
            f"(local {ms0:.1f} ms at read_workers={HTTP_READ_WORKERS})")


class SpanCatalog:
    """A Catalog whose per-repository sessions record their span, open to
    close (the fan-out opens one per repository and closes it when that
    repository's product is done): the federated time split per
    repository."""

    def __init__(self, catalog):
        self._catalog = catalog
        self.spans = {}

    def __getattr__(self, name):
        return getattr(self._catalog, name)

    def open_session(self, repo_id, **kw):
        t0 = time.perf_counter()
        session = self._catalog.open_session(repo_id, **kw)
        close = session.close

        def timed_close():
            close()
            self.spans[repo_id] = (time.perf_counter() - t0) * 1e3

        session.close = timed_close
        return session


def fed_requests():
    from repro_torch.radar import ProductRequest

    return {
        "qvp": ProductRequest(kind="qvp", vcp=VCP_NAME, sweep=QVP_SWEEP),
        "qpe": ProductRequest(kind="qpe", vcp=VCP_NAME, sweep=QPE_SWEEP),
        "mosaic column_max": ProductRequest(kind="mosaic",
                                            product="column_max",
                                            vcp=VCP_NAME),
        "mosaic cappi": ProductRequest(kind="mosaic", product="cappi",
                                       vcp=VCP_NAME),
    }


def fed_held(kind: str, got, want) -> float:
    """A federated product against the same request on the plain version:
    QVP and QPE per repository within the kernels' tolerances, mosaics
    bitwise (every site's grid and the composite); the largest error."""
    import torch

    if list(got.repo_ids) != list(want.repo_ids):
        raise AssertionError(f"federated {kind}: repositories "
                             f"{got.repo_ids} vs {want.repo_ids}")
    err = 0.0
    for rid in want.repo_ids:
        g, w = got.results[rid], want.results[rid]
        if kind == "qvp":
            err = max(err, compare(f"federated qvp {rid}",
                                   torch.from_numpy(g.profile),
                                   torch.from_numpy(w.profile), **QVP_TOL))
        elif kind == "qpe":
            err = max(err, compare(f"federated qpe {rid}",
                                   torch.from_numpy(g.accum_mm),
                                   torch.from_numpy(w.accum_mm), **QPE_TOL))
        elif not (bits_equal(torch.from_numpy(g.values),
                             torch.from_numpy(w.values))
                  and g.times.tobytes() == w.times.tobytes()):
            raise AssertionError(f"federated {kind} {rid}: grid not bitwise "
                                 "equal to the plain version's")
    if kind == "qvp" and not (got.profile.shape == want.profile.shape
                              and np.array_equal(got.times, want.times)):
        raise AssertionError("federated qvp: concatenated axes differ")
    if kind.startswith("mosaic") and not bits_equal(
            torch.from_numpy(got.composite), torch.from_numpy(want.composite)):
        raise AssertionError(f"federated {kind}: composite not bitwise equal")
    return err


def drive_federated_path(archive, vcp, work: str, rows) -> None:
    """Federated QVP, QPE and the column-max and CAPPI mosaics over the
    three sites through ``compute_product(catalog, ..., device=DEV)``,
    each held against the same request on the plain version (grids
    bitwise), with exactly one launch of its kernel per repository, timed
    at ``workers`` 1 and 3 with each repository's span; a time-windowed
    mosaic that fetches fewer chunks than the blind one; the device map
    cache's hits across runs; then an incremental mosaic updated after one
    scan appended to each of KTLX and KICT, bitwise against the
    from-scratch mosaic at those heads.  Returns (catalog, {site: archive},
    {site: (simulator, radar site)}) for the phases after it."""
    import torch
    from repro_torch.radar import compute_product, incremental_product
    from repro_torch.radar import grid as rgrid

    catalog, archives, sims = build_federation(archive, vcp, work)
    n_repos = len(archives)
    fast = os.cpu_count() or 1
    mosaic = None
    for kind, req in fed_requests().items():
        kernel = FED_KERNELS[kind]
        t = time.perf_counter()
        want = compute_product(catalog, req.with_options(mode="ref"),
                               device=DEV, workers=n_repos,
                               read_workers=fast)
        t_ref = (time.perf_counter() - t) * 1e3
        maps = None
        for workers in FED_WORKERS:
            timed = SpanCatalog(catalog)
            sync()
            reset_launches()
            t = time.perf_counter()
            got = compute_product(timed, req, device=DEV, workers=workers)
            wall = (time.perf_counter() - t) * 1e3
            launched = read_launches()
            expect = {k: n_repos if k == kernel else 0
                      for k in kernel_modules()}
            if launched != expect:
                raise AssertionError(f"federated {kind} workers={workers}: "
                                     f"launches {launched}, expected "
                                     f"{expect}")
            rows[kernel]["launches"] = (rows[kernel].get("launches", 0)
                                        + n_repos)
            err = fed_held(kind, got, want)
            fetches = (f", {got.chunk_fetches} chunks fetched"
                       if kind.startswith("mosaic") else "")
            say(f"federated {kind} workers={workers}: {wall:.1f} ms end to "
                f"end over {n_repos} repositories; per repository (session "
                "open to close) "
                + ", ".join(f"{rid} {timed.spans[rid]:.1f} ms"
                            for rid in got.repo_ids)
                + f"; launches {launched}; "
                + ("bitwise equal to mode='ref'" if kind.startswith("mosaic")
                   else f"max_abs_err vs mode='ref' {err:.3e}")
                + f" (mode='ref' at workers={n_repos}, read_workers={fast}: "
                f"{t_ref:.1f} ms){fetches}")
            if kind.startswith("mosaic"):
                # the device maps of the second run are the first run's
                # (the cache hit every site's map: no entry built)
                now = dict(rgrid._DEVICE_MAPS)
                if maps is not None and (now.keys() != maps.keys() or any(
                        now[k] is not maps[k] for k in now)):
                    raise AssertionError(f"federated {kind}: device map "
                                         "cache missed on a repeat run")
                maps = now
        if kind.startswith("mosaic"):
            say(f"federated {kind}: device map cache {len(maps)} entries of "
                f"{rgrid._DEVICE_MAPS_MAX}, every map of the repeat run a "
                "hit; composite "
                f"{got.composite.shape}, {int(np.isfinite(got.composite).sum())}"
                " cells reached")
        if kind == "mosaic column_max":
            mosaic = got
        if kind == "qvp":
            say(f"federated qvp: profile {got.profile.shape} (time x "
                f"height), {len(got.times)} scans over {n_repos} sites")
        if kind == "qpe":
            say(f"federated qpe: {got.total_scans} scans, max accumulation "
                + ", ".join(f"{rid} {float(r.accum_mm.max()):.2f} mm"
                            for rid, r in got.results.items()))

    # a time window: half of the federation's common scans
    t_lo = T0 + (N_SCANS - FED_SCANS) * vcp.interval_s
    window = (t_lo, t_lo + (FED_SCANS // 2 - 1) * vcp.interval_s)
    reset_launches()
    win = compute_product(catalog, fed_requests()["mosaic column_max"]
                          .with_options(time_between=window), device=DEV,
                          workers=n_repos)
    launched = read_launches()
    if launched["grid_map"] != n_repos:
        raise AssertionError(f"windowed mosaic: launches {launched}")
    if not 0 < win.chunk_fetches < mosaic.chunk_fetches:
        raise AssertionError(f"windowed mosaic fetched {win.chunk_fetches} "
                             f"chunks, the blind one {mosaic.chunk_fetches}")
    for rid in win.repo_ids:
        i0 = int(np.searchsorted(mosaic.results[rid].times,
                                 win.results[rid].times[0]))
        n = win.results[rid].values.shape[0]
        if n != FED_SCANS // 2 or not bits_equal(
                torch.from_numpy(win.results[rid].values),
                torch.from_numpy(mosaic.results[rid].values[i0:i0 + n])):
            raise AssertionError(f"windowed mosaic {rid}: not the blind "
                                 "mosaic's scans in the window")
    rows["grid_map"]["launches"] += n_repos
    say(f"federated mosaic column_max, time window of {FED_SCANS // 2} "
        f"scans: {win.chunk_fetches} chunks fetched against "
        f"{mosaic.chunk_fetches} blind; each site's grids bitwise equal to "
        "the blind mosaic's in the window")

    # the incremental mosaic: built at the heads, then one scan appended to
    # each of KTLX and KICT
    req = fed_requests()["mosaic column_max"]
    inc = incremental_product(catalog, req, device=DEV)
    reset_launches()
    t = time.perf_counter()
    boot = inc.update()
    t_boot = (time.perf_counter() - t) * 1e3
    if read_launches()["grid_map"] != n_repos:
        raise AssertionError(f"incremental mosaic build: {boot}")
    for site_id in FED_SITES:
        sid = archives[site_id].append_scan(archive_volume(
            *sims[site_id], vcp, N_SCANS))
        say(f"incremental mosaic: appended scan {N_SCANS} to {site_id}, "
            f"snapshot {sid}")
    reset_launches()
    t = time.perf_counter()
    rep = inc.update()
    t_update = (time.perf_counter() - t) * 1e3
    launched = read_launches()
    if (launched["grid_map"] != len(FED_SITES)
            or rep.n_new_scans != len(FED_SITES)
            or not 0 < rep.cells_computed < rep.cells_full):
        raise AssertionError(f"incremental mosaic update: {rep}, launches "
                             f"{launched}")
    rows["grid_map"]["launches"] += n_repos + len(FED_SITES)
    state = inc.composite()
    t = time.perf_counter()
    full = compute_product(catalog, req.with_options(grid=inc.grid),
                           device=DEV, workers=n_repos, read_workers=fast)
    t_full = (time.perf_counter() - t) * 1e3
    if not bits_equal(torch.from_numpy(state.composite),
                      torch.from_numpy(full.composite)) or not all(
            bits_equal(torch.from_numpy(state.results[rid].values),
                       torch.from_numpy(full.results[rid].values))
            for rid in full.repo_ids):
        raise AssertionError("incremental mosaic: state differs from the "
                             "from-scratch mosaic")
    if not inc.update().noop:
        raise AssertionError("incremental mosaic: a second update at the "
                             "same heads must be a no-op")
    say(f"incremental mosaic column_max: build {t_boot:.1f} ms "
        f"({boot.n_new_scans} scans over {n_repos} sites, {n_repos} "
        f"grid_map launches); after one scan on each of "
        f"{', '.join(FED_SITES)}: update {t_update:.1f} ms, +"
        f"{rep.n_new_scans} scans, cells {rep.cells_computed} of "
        f"{rep.cells_full}, {rep.chunk_fetches} chunks fetched, launches "
        f"{launched}; bitwise equal to the from-scratch mosaic at those "
        f"heads ({t_full:.1f} ms at read_workers={fast}); a second update "
        "is a no-op")
    return catalog, archives, sims



# -- phase 7: the LM serve path ------------------------------------------------

def lm_prompts(archive):
    """``LM_PROMPTS`` radar scans of ``LM_PROMPT_LEN`` tokens from the
    archive (sweep 0, DBZH), the first batch of ``RadarTokenDataset``."""
    from repro_torch.data import RadarTokenDataset

    with archive.session() as session:
        ds = RadarTokenDataset(session, vcp=VCP_NAME, sweep=QPE_SWEEP,
                               moment="DBZH", seq_len=LM_PROMPT_LEN)
        toks = next(iter(ds.batches(LM_PROMPTS, seed=SEED)))["tokens"]
    say(f"lm prompts: {toks.shape[0]} scans of {toks.shape[1]} tokens from "
        f"{VCP_NAME}/sweep_{QPE_SWEEP}/DBZH, {len(np.unique(toks))} distinct "
        f"ids of {ds.tok.vocab_size}")
    return toks


def sync() -> None:
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


def path_launches(cfg):
    """Kernel launches per prefill or decode step under
    ``attn_impl="kernel"``: one ``flash_attention`` per attention layer
    (zamba2's shared block and DeepSeek's MLA layers included) and one
    ``mamba2_scan`` per Mamba-2 layer; xLSTM's mixers launch none."""
    from repro_torch.models.model import layer_groups

    kernel = {"attn": "flash_attention", "shared_attn": "flash_attention",
              "mla": "flash_attention", "mamba2": "mamba2_scan"}
    out = {}
    for reps, unit in layer_groups(cfg):
        for spec in unit:
            name = kernel.get(spec.mixer)
            if name:
                out[name] = out.get(name, 0) + reps
    return out


def fa_step_ms(rows, tag: str):
    """flash_attention's (prefill, decode) ms at a serve path's shapes:
    the tensor-core prefill by CUDA events, the decode call's device time
    (the profiler's, else its CUDA-event time)."""
    pre = rows["flash_attention:tc_prefill"]
    dec = rows["flash_attention:decode"]
    if tag == "lm":
        return pre["ms"], dec.get("device_ms") or dec["ms"]
    if tag == "deepseek":
        pre, dec = pre["deepseek"], dec["deepseek"]
        return pre["ms"], dec.get("device_ms") or dec["ms"]
    return (pre[f"{tag}_ms"],
            dec.get(f"{tag}_device_ms") or dec[f"{tag}_ms"])


def drive_lm_path(archive, rows) -> None:
    """radar-lm-100m at full width serves the archive prompts."""
    drive_serve_path(archive, rows, LM_ARCH, "lm",
                     {"flash_attention": fa_step_ms(rows, "lm")})


def drive_stablelm_path(archive, rows) -> None:
    """stablelm-3b at full width (head dim 80) serves the archive
    prompts."""
    drive_serve_path(archive, rows, STABLELM_ARCH, "stablelm",
                     {"flash_attention": fa_step_ms(rows, "stablelm")})


def drive_zamba2_path(archive, rows) -> None:
    """zamba2-1.2b at full width serves the archive prompts."""
    dec = rows["mamba2_scan:decode"]
    drive_serve_path(archive, rows, ZAMBA_ARCH, "zamba2", {
        "flash_attention": fa_step_ms(rows, "zamba2"),
        "mamba2_scan": (rows["mamba2_scan:chunk_tc"]["ms"],
                        dec.get("device_ms") or dec["ms"])})


def drive_deepseek_path(archive, rows) -> None:
    """deepseek-v2-lite-16b serves the archive prompts: in float32 at full
    width and ``DEEPSEEK_F32_LAYERS`` layers (its 62.8 GB of float32
    parameters and their bf16 copy would not fit the card), then in
    bfloat16 at full depth, its parameters made in bfloat16."""
    drive_serve_path(archive, rows, DEEPSEEK_ARCH, "deepseek",
                     {"flash_attention": fa_step_ms(rows, "deepseek")},
                     f32_layers=DEEPSEEK_F32_LAYERS, bf16_init=True,
                     prefill_profiled=1)


# 8c-ep: deepseek-v2-lite's MLA and MoE blocks at full width in float32
# as the 8 ranks of a production mesh's ``model`` axis hold them (2 of
# the 16 heads, 8 of the 64 experts each), one rank after another in
# this process; a prefill of B 8 x 1024 tokens, then one decode token
EP_RANKS = 8
EP_BATCH, EP_PROMPT = 8, 1024
EP_TOL = dict(rtol=1e-4, atol=1e-5)        # tests/test_torch_mesh_train.py
# 8c-ep's decode step on the latent cache's sequence shards: one cache of
# EP_SEQ_LEN positions (8 shards of 132, as 8c-gqa's), the step at each
# kv_len of EP_SEQ_KV: every shard filled (the last in part), and inside
# rank 0's shard (the other 7 hold no filled position)
EP_SEQ_LEN = 1056
EP_SEQ_KV = (1025, 100)
# float32: the partials' float32 sums in 8 chunks against the whole
# block's in one, as 8c-ep's.  bf16: both sum in float32 too, but the
# attention output is rounded to bf16 before ``wo`` and the token after
# it, where one ulp of a rounding that falls apart moves an output near 1
# by 2**-8 (REC_TOL's)
EP_SEQ_TOL = {"float32": EP_TOL, "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def drive_expert_parallel(rows, card: str) -> None:
    """8c-ep: one MLA block and one MoE block of deepseek-v2-lite at full
    width, float32, from a seed.  Each of the ``EP_RANKS`` ranks' shards
    (``sharding.model_shard``: the rank's heads of ``wq``/``w_uk``/
    ``w_uv``/``wo``, ``w_dkv`` whole; its experts and shared-expert
    columns, the router whole) computes its partial output with no
    process group: the MLA block on the kernel route over a prefill into
    its own latent cache (``flash_attention``'s float32 prefill at 2
    heads of 192, counted) and one decode token (its ``decode`` kernel,
    counted), the MoE block over the same tokens (the sorted dispatch,
    then dropless).  The shards' sum is held against the whole block
    within ``EP_TOL``; one rank's peak bytes beside the whole block's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import model_shard
    from repro_torch.models import attention, moe

    cfg = get_config(DEEPSEEK_ARCH)
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    mla = {k: v.detach() for k, v in attention.init_mla(
        cfg, gen, torch.float32, DEV).items()}
    ffn = {k: v.detach() for k, v in moe.init_moe(
        cfg, gen, torch.float32, DEV).items()}
    B, S, D = EP_BATCH, EP_PROMPT, cfg.d_model
    x = torch.randn((B, S + 1, D), generator=gen, device=DEV)
    pos = torch.arange(S + 1, device=DEV).expand(B, S + 1)
    E = cfg.moe.n_experts

    def block(m, f, offset):
        """(MLA prefill, MLA decode, MoE prefill, MoE decode) outputs and
        the peak bytes allocated above the start while they ran."""
        sync()
        base = torch.cuda.memory_allocated() if DEV == "cuda" else 0
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            cache = attention.init_mla_cache(cfg, B, S + 1, torch.float32,
                                             DEV)
            outs = [attention.apply_mla(cfg, m, x[:, :S], pos[:, :S],
                                        cache=cache, cache_index=0,
                                        impl="kernel")[0],
                    attention.apply_mla(cfg, m, x[:, S:], pos[:, S:],
                                        cache=cache, cache_index=S,
                                        impl="kernel")[0],
                    moe.apply_moe(cfg, f, x[:, :S], expert_offset=offset)[0],
                    moe.apply_moe(cfg, f, x[:, S:], dropless=True,
                                  expert_offset=offset)[0]]
            del cache
        sync()
        peak = (torch.cuda.max_memory_allocated() - base if DEV == "cuda"
                else float("nan"))
        return outs, peak

    whole, whole_peak = block(mla, ffn, 0)
    sums = [torch.zeros_like(o) for o in whole]
    peaks = []
    reset_launches()
    t = time.perf_counter()
    for r in range(EP_RANKS):
        outs, peak = block(model_shard(mla, r, EP_RANKS),
                           model_shard(ffn, r, EP_RANKS),
                           r * E // EP_RANKS)
        peaks.append(peak)
        for acc, o in zip(sums, outs):
            acc.add_(o)
    shards_s = time.perf_counter() - t
    launched, routes = read_launches(), read_routes()
    fa = routes["flash_attention"]
    if launched["flash_attention"] != 2 * EP_RANKS or \
            fa["f32"] != EP_RANKS or fa["decode"] != EP_RANKS:
        raise AssertionError(f"model-axis shards: flash_attention launches "
                             f"{launched['flash_attention']}, by route {fa};"
                             f" want {EP_RANKS} f32 prefills and "
                             f"{EP_RANKS} decodes")
    add_path_launches(rows, launched, routes)
    add_wide_launches(rows)
    errs = [compare(f"model-axis shards {name}: their sum vs the whole "
                    f"block", got, want, **EP_TOL)
            for name, got, want in zip(("MLA prefill", "MLA decode",
                                        "MoE prefill", "MoE decode"),
                                       sums, whole)]

    def weight_bytes(tree):
        return sum(v.numel() * v.element_size() for v in tree.values())

    shard_w = (weight_bytes(model_shard(mla, 0, EP_RANKS))
               + weight_bytes(model_shard(ffn, 0, EP_RANKS)))
    say(f"model-axis shards ({card}): deepseek-v2-lite MLA + MoE blocks at "
        f"full width, float32, B {B} x {S} prefill then 1 decode token; "
        f"{EP_RANKS} ranks' shards ({cfg.n_heads // EP_RANKS} of "
        f"{cfg.n_heads} heads, {E // EP_RANKS} of {E} experts each) "
        f"summed against the whole block: max_abs_err "
        f"{', '.join(f'{e:.3e}' for e in errs)} (MLA prefill, decode, MoE "
        f"prefill, decode; rtol {EP_TOL['rtol']}, atol {EP_TOL['atol']}); "
        f"flash_attention launches {launched['flash_attention']} ({fa}); "
        f"weights a rank {shard_w / 2**30:.3f} GiB against "
        f"{(weight_bytes(mla) + weight_bytes(ffn)) / 2**30:.3f} whole; peak "
        f"bytes above them while computing: rank 0 "
        f"{peaks[0] / 2**30:.3f} GiB (the largest rank "
        f"{max(peaks) / 2**30:.3f}), whole block {whole_peak / 2**30:.3f}; "
        f"the {EP_RANKS} ranks in turn {shards_s:.2f} s")
    drive_mla_sequence_shards(cfg, mla, card)
    del mla, ffn, whole, sums, x
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()


def model_line(tag: str, cfg, params, seconds: float, per_call) -> None:
    """One line of what a serve path built: layers, widths, parameters,
    their dtype and the device memory they hold."""
    import torch
    from repro_torch.models.model import layer_groups

    n_params = sum(p.numel() for p in params.parameters())
    dtype = str(next(iter(params.parameters())).dtype)[6:]
    mixers = sorted({s.mixer for _r, u in layer_groups(cfg) for s in u})
    ffns = sorted({s.ffn for _r, u in layer_groups(cfg) for s in u})
    say(f"{tag}: {cfg.name}: {cfg.n_layers} layers ({', '.join(mixers)}; "
        f"FFN {', '.join(ffns)}), d_model {cfg.d_model}, {cfg.n_heads} "
        f"query / {cfg.n_kv_heads} KV heads, attention width "
        f"{attention_width(cfg)}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{n_params} parameters in {dtype} from init_params(seed=0) on {DEV} "
        f"in {seconds:.1f} s; kernel launches per prefill or step {per_call}"
        + (f"; device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB"
           if DEV == "cuda" else ""))


def expected_launches(per_call, impl: str, steps: int):
    """Each kernel's launches in a generate of ``steps`` decode steps."""
    return {k: per_call.get(k, 0) * (1 + steps) if impl == "kernel" else 0
            for k in kernel_modules()}


def expected_routes(per_call, impl: str, steps: int, dtype: str):
    """The same by route: one prefill call per attention or Mamba-2 layer
    on the dtype's route, then one decode call per layer and step."""
    out = {}
    for name, prefill_route in (
            ("flash_attention", "f32" if dtype == "f32" else "tc_prefill"),
            ("mamba2_scan", "f32" if dtype == "f32" else "chunk_tc")):
        n = per_call.get(name, 0) if impl == "kernel" else 0
        out[name] = {r: 0 for r in kernel_modules()[name].route_launches}
        out[name].update({"decode": n * steps, prefill_route: n})
    return out


def step_margins(cfg, pcfg, params, toks, gen):
    """Top-1 minus top-2 logit of each greedy step of a generate run, from
    the function the engine computes: a prefill of the prompts (a MoE
    layer's sorted dispatch with its drops), then the generated tokens fed
    back one decode step at a time (dropless) -> (B, steps).  A cache-less
    forward over prompt and tokens would be another function where a MoE
    layer drops tokens."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import decode, prefill

    B, S = toks.shape
    caches = M.init_caches(cfg, pcfg, B, LM_MAX_LEN, device=DEV)
    logits, caches = prefill(cfg, pcfg, params, caches,
                             torch.from_numpy(toks).to(DEV), attn_impl="kernel")
    out = []
    for t in range(gen.shape[1]):
        top2 = torch.topk(logits, 2, dim=-1).values
        out.append((top2[:, 0] - top2[:, 1]).cpu())
        if t + 1 < gen.shape[1]:
            step = torch.from_numpy(gen[:, t:t + 1].astype(np.int32)).to(DEV)
            logits, caches = decode(cfg, pcfg, params, caches, step, S + t,
                                    attn_impl="kernel")
    return torch.stack(out, dim=1)


def drive_serve_path(archive, rows, arch: str, tag: str, kernel_ms, *,
                     f32_layers: int = 0, bf16_init: bool = False,
                     prefill_profiled: int = 2) -> None:
    """``arch`` at full width from ``init_params(seed=0)`` serves the
    archive prompts through ``Engine.generate``, greedy: first in float32
    with the kernel route against the non-kernel one (JAX's blocked
    attention core, chunked SSD and sequential recurrence, in plain
    torch), at ``f32_layers`` layers where given, then in bfloat16 as
    ``launch.serve`` runs on the card, at full depth, timed (its
    parameters made anew in bfloat16 with ``bf16_init``).  ``kernel_ms``
    gives each kernel's (prefill, decode) ms at this path's shapes, for
    its share of a step."""
    import torch
    from repro_torch.configs import get_any_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, Request, prefill

    full = get_any_config(arch)
    cfg = (dataclasses.replace(full, n_layers=f32_layers) if f32_layers
           else full)
    per_call = path_launches(cfg)
    t = time.perf_counter()
    params = M.init_params(cfg, 0, device=DEV)
    sync()
    model_line(f"{tag} f32", cfg, params, time.perf_counter() - t, per_call)
    toks = lm_prompts(archive)
    reqs = [Request(p, max_new_tokens=LM_NEW_TOKENS) for p in toks]
    B, S = toks.shape

    # float32: the kernel route against the non-kernel one ---------------------
    f32 = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                         remat="none")
    last = {}
    for impl in ("kernel", "blocked"):
        caches = M.init_caches(cfg, f32, B, LM_MAX_LEN, device=DEV)
        sync()
        t = time.perf_counter()
        last[impl], _ = prefill(cfg, f32, params, caches,
                                torch.from_numpy(toks).to(DEV),
                                attn_impl=impl)
        sync()
        say(f"{tag} f32 prefill attn_impl={impl}: "
            f"{(time.perf_counter() - t) * 1e3:.1f} ms")
        del caches
    err = compare(f"{tag} prefill last-position logits, kernel vs blocked",
                  last["kernel"], last["blocked"], rtol=LOGIT_TOL,
                  atol=LOGIT_TOL)
    say(f"{tag} f32 prefill: last-position logits "
        f"{tuple(last['kernel'].shape)}, kernel vs blocked max_abs_err "
        f"{err:.3e} (tolerance {LOGIT_TOL})")
    gens = {}
    for impl in ("kernel", "blocked"):
        eng = Engine(cfg, f32, params, max_len=LM_MAX_LEN, attn_impl=impl,
                     device=DEV)
        reset_launches()
        out = eng.generate(reqs, seed=SEED)
        launched, routes = read_launches(), read_routes()
        gens[impl] = np.stack([o.tokens for o in out])
        expect = expected_launches(per_call, impl, eng.decode_steps)
        expect_routes = expected_routes(per_call, impl, eng.decode_steps,
                                        "f32")
        say(f"{tag} f32 generate attn_impl={impl}: {gens[impl].shape} "
            f"tokens, {eng.decode_steps} decode steps, kernel launches "
            f"{launched}, by route {routes}")
        if launched != expect or routes != expect_routes:
            raise AssertionError(f"{tag} {impl}: expected launches {expect} "
                                 f"by route {expect_routes}, got {launched} "
                                 f"by route {routes}")
        if impl == "kernel":
            # the bf16 path never takes the f32 routes: their launches are
            # counted here, the other kernels' from the bf16 run
            for name in ROUTED:
                if routes[name]["f32"]:
                    row = rows[f"{name}:f32"]
                    row["launches"] = (row.get("launches", 0)
                                       + routes[name]["f32"])
            add_wide_launches(rows)
        if gens[impl].shape != (B, LM_NEW_TOKENS) or not all(
                o.finished == "length" for o in out):
            raise AssertionError(f"{tag} {impl}: completions "
                                 f"{gens[impl].shape}")
    # the margins along the kernel's run
    margins = step_margins(cfg, f32, params, toks, gens["kernel"])
    min_margin = float(margins.min())
    same = gens["kernel"] == gens["blocked"]
    if min_margin > LOGIT_TOL:
        if not same.all():
            raise AssertionError(f"{tag}: greedy tokens differ between the "
                                 "kernel and the blocked route")
        say(f"{tag} f32 greedy tokens: kernel == blocked for all "
            f"{same.size}; smallest top-1/top-2 margin {min_margin:.4e} > "
            f"{LOGIT_TOL}")
    else:
        # each row is compared up to its first step within the tolerance
        for i in range(B):
            low = np.flatnonzero(margins[i].numpy() <= LOGIT_TOL)
            n = int(low[0]) if low.size else LM_NEW_TOKENS
            if not same[i, :n].all():
                raise AssertionError(f"{tag}: greedy tokens of request {i} "
                                     f"differ before step {n}")
        say(f"{tag} f32 greedy tokens: kernel == blocked up to each row's "
            f"first step with a top-1/top-2 margin <= {LOGIT_TOL} "
            f"(smallest margin {min_margin:.4e}); {int(same.sum())} of "
            f"{same.size} equal")

    if bf16_init or cfg is not full:
        del params, last
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        params = M.init_params(full, 0, device=DEV,
                               dtype=torch.bfloat16 if bf16_init
                               else torch.float32)
        sync()
        model_line(f"{tag} bf16", full, params, time.perf_counter() - t,
                   path_launches(full))
    serve_bf16(full, params, toks, rows, tag, kernel_ms,
               f32_tokens=gens["kernel"] if cfg is full else None,
               prefill_profiled=prefill_profiled)


def serve_bf16(cfg, params, toks, rows, tag: str, kernel_ms, *,
               f32_tokens=None, n_prefill: int = 3,
               prefill_profiled: int = 2,
               profile_len: Optional[int] = None) -> None:
    """``cfg`` serves the prompts ``toks`` in bfloat16, as ``launch.serve``
    runs on the card: one ``Engine.generate`` timed, with its launches
    (by route), the MoE dispatches and drops, and peak memory; then the
    split (``n_prefill`` prefills, single decode steps) with each kernel's
    share, and ``torch.profiler`` over ``prefill_profiled`` prefills and 4
    decode steps.  With ``profile_len`` the warm-up generate and the
    traced prefills take the prompts' first ``profile_len`` tokens (a
    prefill that steps token by token, traced whole, is a long trace)."""
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve import Engine, Request

    per_call = path_launches(cfg)
    reqs = [Request(p, max_new_tokens=LM_NEW_TOKENS) for p in toks]
    B, S = toks.shape
    bf16 = ParallelConfig(compute_dtype="bfloat16",
                          kv_cache_dtype="bfloat16", remat="none")
    eng = Engine(cfg, bf16, params, max_len=LM_MAX_LEN, device=DEV)
    warm = [Request(toks[0][:profile_len], max_new_tokens=LM_NEW_TOKENS)
            if profile_len else reqs[0]]
    eng.generate(warm, seed=SEED)              # warm-up (allocator, cuBLAS)
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    moe.dispatches.update(dict.fromkeys(moe.dispatches, 0))
    moe.dropped = 0
    steps0 = eng.decode_steps
    t = time.perf_counter()
    out = eng.generate(reqs, seed=SEED)
    sync()
    wall = time.perf_counter() - t
    launched, routes = read_launches(), read_routes()
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda"
               else float("nan"))
    steps = eng.decode_steps - steps0
    new = sum(len(o.tokens) for o in out)
    if launched != expected_launches(per_call, "kernel", steps) or \
            routes != expected_routes(per_call, "kernel", steps, "bf16"):
        raise AssertionError(f"{tag} bf16: launches {launched} by route "
                             f"{routes}, {steps} steps")
    gen_bf16 = np.stack([o.tokens for o in out])
    if gen_bf16.shape != (B, LM_NEW_TOKENS) or gen_bf16.min() < 0 \
            or gen_bf16.max() >= cfg.vocab_size:
        raise AssertionError(f"{tag} bf16: tokens {gen_bf16.shape}")
    moe_note = ""
    if cfg.moe is not None:
        # a prefill of B x S > 64 tokens takes the sorted dispatch, each
        # decode step the dropless one, in every MoE layer
        n_moe = sum(reps for reps, unit in M.layer_groups(cfg)
                    for spec in unit if spec.ffn == "moe")
        want = {"sorted": n_moe, "dropless": n_moe * steps, "einsum": 0}
        if moe.dispatches != want:
            raise AssertionError(f"{tag} bf16: MoE dispatches "
                                 f"{moe.dispatches}, expected {want}")
        assigned = n_moe * B * S * cfg.moe.top_k
        moe_note = (f"; MoE dispatches {moe.dispatches} (the prefill "
                    f"sorted at capacity {moe.capacity(cfg, B * S)} a "
                    f"layer, each step dropless), {int(moe.dropped)} of "
                    f"{assigned} prefill assignments dropped at capacity "
                    f"({int(moe.dropped) / assigned:.2%})")
    same = ("" if f32_tokens is None else
            f"; {int((gen_bf16 == f32_tokens).sum())} of {gen_bf16.size} "
            "tokens equal to the float32 run")
    say(f"{tag} bf16 generate: {B} requests x {LM_NEW_TOKENS} new tokens "
        f"after {S}-token prompts in {wall * 1e3:.1f} ms = {new / wall:.1f} "
        f"tokens/s; kernel launches {launched}, by route "
        f"{routes}; peak device memory "
        f"{peak_gb:.2f} GB (max_memory_allocated){same}{moe_note}")
    add_path_launches(rows, launched, routes)
    add_wide_launches(rows)

    prompt = torch.from_numpy(toks).to(DEV)
    if "mamba2_scan" in per_call:
        check_scan_logits(cfg, bf16, eng.cparams, prompt, tag)

    # the split: prefill, then single decode steps, then each traced
    pre, dec, caches, nxt = serve_split(cfg, bf16, eng.cparams, prompt,
                                        n_prefill=n_prefill)
    pre_ms, dec_ms = statistics.median(pre), statistics.median(dec)
    shares = "; ".join(
        f"{name} {n} x {kernel_ms[name][0]:.4f} ms = "
        f"{n * kernel_ms[name][0] / pre_ms:.1%} of prefill, {n} x "
        f"{kernel_ms[name][1]:.4f} ms = "
        f"{n * kernel_ms[name][1] / dec_ms:.1%} of a decode step"
        for name, n in per_call.items()) or "no hand kernel on this path"
    say(f"time {tag} bf16: prefill {pre_ms:.2f} ms ({B} x {S} tokens, "
        f"median of {len(pre)}: {', '.join(f'{x:.2f}' for x in pre)}), "
        f"decode {dec_ms:.3f} ms per step of {B} tokens "
        f"(median of {len(dec)}, {B / dec_ms * 1e3:.1f} tokens/s); "
        f"{shares}")
    profile_prefill(cfg, bf16, eng.cparams, prompt, pre_ms, tag=tag,
                    n=prefill_profiled, profile_len=profile_len)
    profile_decode(cfg, bf16, eng.cparams, caches, nxt, S + len(dec),
                   dec_ms, tag=tag)


def drive_xlstm_path(archive, rows) -> None:
    """xlstm-1.3b serves the archive prompts: in float32 at full width and
    one unit (7 mLSTM and 1 sLSTM layers), the recurrent prefill's
    last-position logits within ``LOGIT_TOL`` of the chunked cache-less
    forward's (the reference's own check, tests/test_archs.py:67, here
    the two mLSTM forms against each other on the card); then in
    bfloat16 at full depth, timed.  Its mixers launch no hand kernel: the
    counts must stay 0."""
    import torch
    from repro_torch.configs import get_any_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import model as M
    from repro_torch.serve import prefill

    full = get_any_config(XLSTM_ARCH)
    cfg = dataclasses.replace(full, n_layers=full.xlstm.slstm_every)
    t = time.perf_counter()
    params = M.init_params(cfg, 0, device=DEV)
    sync()
    model_line("xlstm f32", cfg, params, time.perf_counter() - t, {})
    toks = lm_prompts(archive)
    prompt = torch.from_numpy(toks).to(DEV)
    f32 = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                         remat="none")
    reset_launches()
    caches = M.init_caches(cfg, f32, toks.shape[0], LM_MAX_LEN, device=DEV)
    sync()
    t = time.perf_counter()
    rec, caches = prefill(cfg, f32, params, caches, prompt)
    sync()
    rec_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    chunked, _ = M.forward(cfg, f32, params, {"tokens": prompt},
                           attn_impl="kernel")
    sync()
    fwd_ms = (time.perf_counter() - t) * 1e3
    launched = read_launches()
    if any(launched.values()):
        raise AssertionError(f"xlstm f32: kernel launches {launched}")
    err = compare("xlstm f32 prefill last-position logits, recurrent vs "
                  "chunked", rec, chunked[:, -1], rtol=LOGIT_TOL,
                  atol=LOGIT_TOL)
    state = caches[0][0]["C"]
    say(f"xlstm f32 ({cfg.n_layers} layers): the recurrent prefill "
        f"({rec_ms:.1f} ms, {toks.shape[1]} steps a layer) against the "
        f"chunked forward ({fwd_ms:.1f} ms, chunk {cfg.xlstm.chunk}): "
        f"last-position logits {tuple(rec.shape)} max_abs_err {err:.3e} "
        f"(tolerance {LOGIT_TOL}); mLSTM state {tuple(state.shape[1:])} "
        f"float32 finite {bool(torch.isfinite(state).all())}; kernel "
        f"launches {launched}")
    del params, caches, rec, chunked
    gc.collect()
    t = time.perf_counter()
    params = M.init_params(full, 0, device=DEV)
    sync()
    model_line("xlstm bf16", full, params, time.perf_counter() - t, {})
    serve_bf16(full, params, toks, rows, "xlstm", {},
               n_prefill=XLSTM_PREFILLS, prefill_profiled=1,
               profile_len=XLSTM_PROFILE_LEN)


class ScanShim:
    """Stands in for ``kernels.ops`` in ``models.ssm`` (its only use there
    is ``mamba2_scan``): the scan is ``fn(x, dt, A, Bmat, Cmat, h0)``."""

    def __init__(self, fn):
        self.fn = fn

    def mamba2_scan(self, x, dt, A, Bmat, Cmat, *, h0=None, mode="auto"):
        return self.fn(x, dt, A, Bmat, Cmat, h0)


def plain_scan(x, dt, A, Bmat, Cmat, h0):
    """The scan's plain version, the sequential recurrence."""
    from repro_torch.kernels import ref

    return ref.mamba2_scan(x, dt, A, Bmat, Cmat, h0=h0)


def check_scan_logits(cfg, pcfg, cparams, prompt, tag: str) -> None:
    """The bf16 prefill's last-position logits on the kernel routes
    against the same prefill with only the Mamba-2 scan on its plain
    version, row by row (``SSM_LOGIT_ROW_TOL``); the same gate must reject
    the plain version with the planted fault ``SSM_LOGIT_FAULT``."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.serve import prefill

    def last_logits(kops=None):
        saved = ssm.kops
        if kops is not None:
            ssm.kops = kops
        try:
            caches = M.init_caches(cfg, pcfg, prompt.shape[0], LM_MAX_LEN,
                                   device=DEV)
            logits, _ = prefill(cfg, pcfg, cparams, caches, prompt)
            sync()
            return logits.float()
        finally:
            ssm.kops = saved

    got = last_logits()
    want = last_logits(ScanShim(plain_scan))
    bad = last_logits(ScanShim(lambda *a: ssm_fault(*a, SSM_LOGIT_FAULT)))
    err, err_bad = row_rel_err(got, want), row_rel_err(bad, want)
    if not err <= SSM_LOGIT_ROW_TOL:
        raise AssertionError(f"{tag} bf16 prefill: last-position logits on "
                             f"the kernel routes {err:.3e} from the plain "
                             f"scan's, above {SSM_LOGIT_ROW_TOL}")
    if err_bad <= SSM_LOGIT_ROW_TOL:
        raise AssertionError(f"{tag} bf16 prefill: the planted fault's "
                             f"logits error {err_bad:.3e} passes the gate")
    say(f"check {tag} bf16 prefill last-position logits {tuple(got.shape)}, "
        f"kernel routes vs the plain scan: worst row error {err:.3e} "
        f"(tolerance {SSM_LOGIT_ROW_TOL}); the planted fault (M formed "
        f"above the diagonal) {err_bad:.3e}, finite logits "
        f"{bool(torch.isfinite(bad).all())}: rejected")


def serve_split(cfg, pcfg, cparams, prompt, n_prefill: int = 3,
                n_steps: int = LM_NEW_TOKENS):
    """``n_prefill`` prefills of ``prompt``, each into fresh caches, then
    ``n_steps`` greedy decode steps after the last, each timed by the host
    clock around a synchronised call: (prefill ms, step ms, caches, next
    tokens)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import decode, prefill

    B, S = prompt.shape
    pre, dec = [], []
    for _ in range(n_prefill):
        caches = M.init_caches(cfg, pcfg, B, LM_MAX_LEN, device=DEV)
        sync()
        t = time.perf_counter()
        logits, caches = prefill(cfg, pcfg, cparams, caches, prompt)
        sync()
        pre.append((time.perf_counter() - t) * 1e3)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    for i in range(n_steps):
        t = time.perf_counter()
        logits, caches = decode(cfg, pcfg, cparams, caches, nxt, S + i)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        sync()
        dec.append((time.perf_counter() - t) * 1e3)
    return pre, dec, caches, nxt


def trace_device(run, n: int, warmup: int = 2):
    """``run(i)`` for i < ``warmup + n`` under ``torch.profiler`` (device
    activity only; the first ``warmup >= 1`` calls traced but left out, so
    the profiler's start-up stays out, and finished on the card before the
    window opens, so a device-bound call's queue does not spill into it).
    Per call of the last ``n``: (device kernels, their busy ms, the five
    busiest kernel names with their ms, host ms under the profiler); None
    when it saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    sync()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=n,
                                   repeat=1)) as prof:
        for i in range(warmup + n):
            run(i)
            if i == warmup - 1:
                sync()
                t = time.perf_counter()
            elif i == warmup + n - 1:
                sync()
                wall_ms = (time.perf_counter() - t) * 1e3 / n
            prof.step()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / n
    if not kernels or busy_ms <= 0:
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return len(kernels) / n, busy_ms, top, wall_ms


def say_trace(label: str, traced, call_ms: float, what: str) -> None:
    """One line of a ``trace_device`` result against ``call_ms``, the time
    of one call measured without the profiler."""
    if traced is None:
        say(f"profile {label}: the profiler saw no device time; busy share "
            "not measured")
        return
    per_call, busy_ms, top, wall_ms = traced
    say(f"profile {label}: {per_call:.0f} device kernels per {what}, device "
        f"busy {busy_ms:.3f} ms per {what} = {busy_ms / call_ms:.1%} of the "
        f"{call_ms:.3f} ms measured without the profiler (idle "
        f"{1 - busy_ms / call_ms:.1%}; {wall_ms:.3f} ms per {what} under the "
        f"profiler); host time per launch "
        f"{(call_ms - busy_ms) / per_call * 1e3:.1f} us; per {what}: "
        + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))


def profile_prefill(cfg, pcfg, cparams, prompt, prefill_ms: float,
                    n: int = 2, warmup: int = 1, tag: str = "lm",
                    profile_len: Optional[int] = None):
    """``n`` prefills traced (after ``warmup``), each into caches made
    before the trace, against ``prefill_ms``; with ``profile_len``,
    prefills of the prompts' first ``profile_len`` tokens, against one
    such prefill timed here without the profiler."""
    from repro_torch.models import model as M
    from repro_torch.serve import prefill

    if DEV != "cuda":
        return
    caches = [M.init_caches(cfg, pcfg, prompt.shape[0], LM_MAX_LEN,
                            device=DEV)
              for _ in range(warmup + n + (2 if profile_len else 0))]
    what = f"{n} prefills traced"
    if profile_len:
        prompt = prompt[:, :profile_len]
        prefill(cfg, pcfg, cparams, caches.pop(), prompt)       # warm-up
        sync()
        t = time.perf_counter()
        prefill(cfg, pcfg, cparams, caches.pop(), prompt)
        sync()
        prefill_ms = (time.perf_counter() - t) * 1e3
        what += f" of the first {profile_len} tokens"
    traced = trace_device(
        lambda i: prefill(cfg, pcfg, cparams, caches[i], prompt), n, warmup)
    say_trace(f"{tag} prefill ({what})", traced, prefill_ms, "prefill")


def profile_decode(cfg, pcfg, cparams, caches, nxt, start, step_ms: float,
                   n: int = 4, warmup: int = 2, tag: str = "lm"):
    """``n`` decode steps traced (after ``warmup``), against ``step_ms``."""
    import torch
    from repro_torch.serve import decode

    if DEV != "cuda":
        return
    state = {"caches": caches, "nxt": nxt}

    def step(i):
        logits, state["caches"] = decode(cfg, pcfg, cparams, state["caches"],
                                         state["nxt"], start + i)
        state["nxt"] = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]

    say_trace(f"{tag} decode ({n} steps traced)",
              trace_device(step, n, warmup), step_ms, "step")


# -- phase 6e: Raw2Zarr ingest, the DataTree view and the live feed -------------

# raw VCP-212 volumes at full width (720 x 1192), sweeps 0-4 of 14, every
# moment the format carries (7); ingested at the first of INGEST_WORKERS,
# then the first INGEST_SERIAL_SCANS of them at each, the ids held equal;
# then FEED_SCANS live scans appended one commit each
INGEST_SCANS = 16
INGEST_SWEEPS = 5
INGEST_T0 = 1305849600.0          # generate_raw_archive's and the feed's t0
INGEST_WORKERS = (8, 1)
INGEST_SERIAL_SCANS = 4           # the serial run's depth, cut for time
FEED_SCANS = 2


def drive_ingest_path(work: str, rows) -> str:
    """Raw files from ``generate_raw_archive``, ingested by
    ``repro_torch.etl.ingest`` at the first of ``INGEST_WORKERS`` into a
    fresh repository registered in a ``Catalog`` from its report, then the
    first ``INGEST_SERIAL_SCANS`` volumes at each of ``INGEST_WORKERS``
    (equal snapshot ids); the DataTree view of the result; QVP and
    QPE through ``compute_product`` on the card, one launch each, held
    against ``mode="ref"``; then a ``LiveFeed`` of ``FEED_SCANS`` scans of
    ``live_scan_feed`` with the catalog: its head advances per scan and an
    incremental CAPPI, one ``grid_map`` launch an update, stays bitwise the
    product rebuilt from scratch.  Returns the archive's path (the
    training path's data)."""
    import torch
    from repro_torch import etl
    from repro_torch.catalog import Catalog
    from repro_torch.core import RadarArchive, fm301
    from repro_torch.radar import (ProductRequest, compute_product,
                                   incremental_product)
    from repro_torch.store import ObjectStore, Repository

    full = fm301.VCPS[VCP_NAME]
    shape = (INGEST_SCANS, full.n_azimuth, full.n_gates)
    raw = ObjectStore(os.path.join(work, "raw"))
    t = time.perf_counter()
    # scan i is the simulator's volume at t0 + i x interval, a pure
    # function of (seed, time, geometry): one call a scan, on 8 threads,
    # writes the files of one call for all of them
    with ThreadPoolExecutor(max_workers=8) as pool:
        per_scan = list(pool.map(
            lambda i: etl.generate_raw_archive(
                raw, n_scans=1, t0=INGEST_T0 + i * full.interval_s,
                n_sweeps=INGEST_SWEEPS, seed=SEED),
            range(INGEST_SCANS)))
    keys = [k for ks in per_scan for k in ks]
    say(f"ingest: {len(keys)} raw {VCP_NAME} volumes ({shape[1]} x "
        f"{shape[2]}, sweeps 0-{INGEST_SWEEPS - 1}, {len(full.moments)} "
        "moments) written in "
        f"{time.perf_counter() - t:.1f} s")
    cat = Catalog.create(os.path.join(work, "catalog"))

    def run(w, tag, run_keys=None, catalog=None):
        path = os.path.join(work, f"ingest-{tag}")
        repo = Repository.create(path)
        reset_launches()
        rep = etl.ingest(raw, repo, keys=run_keys, workers=w, catalog=catalog)
        launched = read_launches()
        if any(launched.values()):
            raise AssertionError(f"ingest launched kernels: {launched}")
        objs, size = store_bytes(path)
        st = rep.stage_seconds
        say(f"ingest workers={w}: {rep.n_files} files, "
            f"{rep.bytes_read / 1e6:.1f} MB raw read, {rep.n_volumes} volumes "
            f"in {rep.n_commits} commit(s); stage seconds extract "
            f"{st['extract_s']:.3f}, decode {st['decode_s']:.3f}, load "
            f"{st['load_s']:.3f}, wall {st['wall_s']:.3f}; archive "
            f"{size / 1e6:.1f} MB in {objs} objects")
        return path, rep

    ingested, _rep = run(INGEST_WORKERS[0], "all", catalog=cat)
    sub = sorted(k for ks in per_scan[:INGEST_SERIAL_SCANS] for k in ks)
    first, last = (run(w, f"w{w}", sub)[1] for w in INGEST_WORKERS)
    if first.snapshot_ids != last.snapshot_ids or not first.snapshot_ids:
        raise AssertionError(f"ingest snapshot ids differ between workers: "
                             f"{first.snapshot_ids} vs {last.snapshot_ids}")
    say(f"ingest: snapshot ids equal at workers {INGEST_WORKERS} over the "
        f"first {INGEST_SERIAL_SCANS} volumes: {first.snapshot_ids}")
    repo = Repository.open(ingested)
    entry = cat.entry("KVNX")
    if (entry.snapshot_id != repo.branch_head()
            or entry.vcps[VCP_NAME]["n_times"] != INGEST_SCANS):
        raise AssertionError(f"catalog entry after ingest: {entry}")

    # the DataTree view of what was ingested
    archive = RadarArchive(repo)
    tree = archive.tree()
    dbz = tree[f"{VCP_NAME}/sweep_0/DBZH"]
    if (dbz.shape != shape or not dbz.lazy
            or tree[f"{VCP_NAME}/time"].shape != (INGEST_SCANS,)):
        raise AssertionError(f"ingested tree: {dbz!r}")
    coords, values = dbz.where((slice(0, 2),), value_gt=45.0)
    say(f"ingest tree: {sum(1 for _ in tree.subtree())} nodes, "
        f"{VCP_NAME}/sweep_0/DBZH {dbz.shape}; where(scans 0-1, > 45 dBZ) "
        f"found {values.size} gates")

    # QVP and QPE on the ingested archive, on the card
    for product, req, kernel, tol in (
            ("qvp", ProductRequest(kind="qvp", vcp=VCP_NAME,
                                   sweep=INGEST_SWEEPS - 1),
             "qvp_reduce", QVP_TOL),
            ("qpe", ProductRequest(kind="qpe", vcp=VCP_NAME, sweep=0),
             "zr_accum", QPE_TOL)):
        with archive.session() as session:
            reset_launches()
            t = time.perf_counter()
            got = compute_product(session, req, device=DEV)
            ms = (time.perf_counter() - t) * 1e3
            launched = read_launches()
            want = compute_product(session, req.with_options(mode="ref"),
                                   device=DEV)
        if launched[kernel] != 1 or sum(launched.values()) != 1:
            raise AssertionError(f"ingested {product}: launches {launched}")
        add_path_launches(rows, launched, read_routes())
        field = "profile" if product == "qvp" else "accum_mm"
        err = compare(f"ingested {product} vs plain on the card",
                      torch.from_numpy(getattr(got, field)),
                      torch.from_numpy(getattr(want, field)), **tol)
        say(f"ingest path {product}: {getattr(got, field).shape} in "
            f"{ms:.1f} ms, 1 {kernel} launch, max_abs_err vs plain {err:.3e}")

    # the live feed: scans after the ingested ones, one commit each
    inc = incremental_product(repo, ProductRequest(kind="cappi",
                                                   vcp=VCP_NAME),
                              device=DEV)
    reset_launches()
    inc.update()
    built = read_launches()
    add_path_launches(rows, built, read_routes())
    feed = etl.LiveFeed(repo, etl.live_scan_feed(
        site_id="KVNX", vcp_name=VCP_NAME, t0=INGEST_T0, seed=SEED,
        n_sweeps=INGEST_SWEEPS, start=INGEST_SCANS),
        workers=INGEST_WORKERS[0], catalog=cat,
        repo_id="KVNX")
    for i in range(FEED_SCANS):
        t = time.perf_counter()
        sid = feed.ingest_next(1)
        t_commit = time.perf_counter() - t
        if len(sid) != 1 or cat.entry("KVNX").snapshot_id != sid[0] \
                or sid[0] != repo.branch_head():
            raise AssertionError(f"live feed scan {i}: commit {sid}, catalog "
                                 f"head {cat.entry('KVNX').snapshot_id}")
        reset_launches()
        t = time.perf_counter()
        rep = inc.update()
        t_update = time.perf_counter() - t
        launched = read_launches()
        if launched["grid_map"] != 1 or sum(launched.values()) != 1:
            raise AssertionError(f"live feed CAPPI update: launches "
                                 f"{launched}")
        add_path_launches(rows, launched, read_routes())
        with repo.readonly_session() as session:
            t = time.perf_counter()
            rebuilt = compute_product(session, ProductRequest(
                kind="cappi", vcp=VCP_NAME, grid=inc.read().grid),
                device=DEV)
            t_full = time.perf_counter() - t
        state = inc.read()
        if not (bits_equal(torch.from_numpy(state.values),
                           torch.from_numpy(rebuilt.values))
                and state.times.tobytes() == rebuilt.times.tobytes()):
            raise AssertionError(f"live feed scan {i}: incremental CAPPI "
                                 "differs from the rebuilt one")
        say(f"live feed scan {INGEST_SCANS + i}: committed in "
            f"{t_commit * 1e3:.1f} ms (snapshot {sid[0][:12]}, the catalog "
            f"head with it); CAPPI update {t_update * 1e3:.1f} ms (cells "
            f"{rep.cells_computed} of {rep.cells_full}, 1 grid_map) vs "
            f"rebuilt {t_full * 1e3:.1f} ms; bitwise equal")
    n_times = cat.entry("KVNX").vcps[VCP_NAME]["n_times"]
    if n_times != INGEST_SCANS + FEED_SCANS:
        raise AssertionError(f"catalog n_times {n_times}")
    return ingested


# -- phase 9: training from the archive, a checkpoint, and serving it ---------

TRAIN_STEPS = 12
TRAIN_CKPT_EVERY = 6
TRAIN_RESUME_RTOL = 1e-2
# the remat policies beside the checkpointed run's "block" (its first
# steps): steps of each, the losses held to TRAIN_RESUME_RTOL
REMAT_STEPS = 6
# launch.train's own defaults: batch 8, seq 512, bf16 compute on the card;
# the CPU rehearsal adds --reduced and smaller shapes here
TRAIN_EXTRA_ARGS: list = []
# the served requests: launch.serve's prompts (default_rng(0))
SERVE_CKPT = dict(requests=8, prompt_len=64, new_tokens=16, max_len=128)


def drive_train_path(data: str, work: str, rows) -> None:
    """``launch.train`` on ``radar-lm-100m`` at full width, tokens from the
    ingested archive, ``TRAIN_STEPS`` steps with a checkpoint every
    ``TRAIN_CKPT_EVERY`` in the port's ``Repository``; the repository
    rolled back to the first checkpoint and a second run resumed from it,
    its losses within ``TRAIN_RESUME_RTOL`` of the uninterrupted run's;
    the cell under ``--remat none`` and ``--remat dots`` beside it
    (:func:`drive_remat_policies`); then ``launch.serve --ckpt`` on the
    newest checkpoint, its greedy tokens equal to an engine serving the
    trained parameters held in memory."""
    import torch
    from repro_torch.configs import get_any_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch import serve, train
    from repro_torch.models.convert import from_reference
    from repro_torch.serve import Engine
    from repro_torch.store import Repository
    from repro_torch.train import CheckpointManager

    ck = os.path.join(work, "ckpt")
    argv = ["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS), "--data", data,
            "--ckpt", ck, "--ckpt-every", str(TRAIN_CKPT_EVERY),
            "--device", DEV, "--log-every", "5", *TRAIN_EXTRA_ARGS]
    reset_launches()
    t = time.perf_counter()
    whole = train.main(argv)
    t_whole = time.perf_counter() - t
    launched = read_launches()
    mgr = CheckpointManager(Repository.open(ck))
    steps = mgr.steps()
    if steps != list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS + 1,
                           TRAIN_CKPT_EVERY)):
        raise AssertionError(f"checkpoints at {steps}")
    losses = [whole["losses"][s] for s in range(1, TRAIN_STEPS + 1)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    args = train._parser().parse_args(argv)
    tokens = args.batch * args.seq
    step_ms = statistics.median(whole["step_s"][2:] or whole["step_s"]) * 1e3
    peak = whole["peak_bytes"]
    say(f"train {LM_ARCH}: {TRAIN_STEPS} steps in {t_whole:.1f} s with "
        f"{len(steps)} checkpoints; median step {step_ms:.1f} ms (steps 3 "
        f"on, synchronised), {tokens / step_ms * 1e3:.0f} tokens/s, peak "
        f"memory {'not measured' if peak is None else f'{peak / 1e9:.2f} GB'}"
        f"; loss {losses[0]:.4f} at step 1, {losses[-1]:.4f} at step "
        f"{TRAIN_STEPS}; kernel launches {launched} (training runs the "
        "blocked attention core, as the reference)")
    mgr.rollback_to(TRAIN_CKPT_EVERY)
    t = time.perf_counter()
    resumed = train.main(argv)
    t_resumed = time.perf_counter() - t
    if resumed["start_step"] != TRAIN_CKPT_EVERY:
        raise AssertionError(f"resumed at {resumed['start_step']}")
    worst = 0.0
    for s in range(TRAIN_CKPT_EVERY + 1, TRAIN_STEPS + 1):
        a, b = resumed["losses"][s], whole["losses"][s]
        worst = max(worst, abs(a - b) / abs(b))
    if worst > TRAIN_RESUME_RTOL:
        raise AssertionError(f"resumed losses differ by {worst:.3e} "
                             "relative")
    say(f"train resumed from step {TRAIN_CKPT_EVERY} in {t_resumed:.1f} s: "
        f"steps {TRAIN_CKPT_EVERY + 1}-{TRAIN_STEPS} within {worst:.3e} "
        f"relative of the uninterrupted run (tolerance {TRAIN_RESUME_RTOL})")
    drive_remat_policies(data)

    # serve the newest checkpoint; the same requests on the trained
    # parameters held in memory
    reduced = "--reduced" in TRAIN_EXTRA_ARGS
    sargv = ["--arch", LM_ARCH, "--ckpt", ck, "--device", DEV,
             *(["--reduced"] if reduced else [])]
    for key, value in SERVE_CKPT.items():
        sargv += [f"--{key.replace('_', '-')}", str(value)]
    reset_launches()
    t = time.perf_counter()
    outs = serve.main(sargv)
    t_serve = time.perf_counter() - t
    launched, routes = read_launches(), read_routes()
    prefill = "f32" if DEV == "cpu" else "tc_prefill"
    if not (routes["flash_attention"][prefill]
            and routes["flash_attention"]["decode"]):
        raise AssertionError(f"serving the checkpoint launched {routes}")
    add_path_launches(rows, launched, routes)
    cfg = get_any_config(LM_ARCH)
    if reduced:
        cfg = cfg.reduced()
    dtype = "float32" if DEV == "cpu" else "bfloat16"
    pcfg = ParallelConfig(compute_dtype=dtype, kv_cache_dtype=dtype,
                          remat="none")
    params = from_reference(cfg, resumed["state"].params, device=DEV)
    eng = Engine(cfg, pcfg, params, max_len=SERVE_CKPT["max_len"],
                 device=DEV)
    want = eng.generate(serve.make_requests(
        cfg, SERVE_CKPT["requests"], SERVE_CKPT["prompt_len"],
        SERVE_CKPT["new_tokens"]), seed=1)
    for i, (a, b) in enumerate(zip(outs, want)):
        if not np.array_equal(np.asarray(a.tokens), np.asarray(b.tokens)):
            raise AssertionError(f"served request {i}: the checkpoint's "
                                 "tokens differ from the in-memory ones")
    if DEV == "cuda":
        torch.cuda.synchronize()
    say(f"serve --ckpt {LM_ARCH} (step {TRAIN_STEPS}): {len(outs)} requests "
        f"in {t_serve:.1f} s with the restore, greedy tokens equal to the "
        f"trained parameters in memory; launches {routes}")


def drive_remat_policies(data: str) -> None:
    """``launch.train --remat none``, ``block`` and ``dots``,
    ``REMAT_STEPS`` steps each of phase 9's cell: ms a step and the peak
    of ``max_memory_allocated`` above what was allocated before the run
    (the run's own state and step), the losses held to
    ``TRAIN_RESUME_RTOL`` of ``block``'s; then the forward and backward
    passes alone under each policy (:func:`passes_memory`)."""
    import torch
    from repro_torch.configs import get_any_config
    from repro_torch.launch import train

    argv = ["--arch", LM_ARCH, "--steps", str(REMAT_STEPS), "--data", data,
            "--device", DEV, "--log-every", "5", *TRAIN_EXTRA_ARGS]
    runs, peaks = {}, {}
    for remat in ("none", "block", "dots"):
        gc.collect()
        base = None
        if DEV == "cuda":
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
        runs[remat] = train.main(argv + ["--remat", remat])
        if base is not None:
            peaks[remat] = runs[remat]["peak_bytes"] - base
        state = runs[remat].pop("state")
        if remat == "block":
            params = state.params
        del state
    block = runs["block"]
    worst = max(abs(runs[r]["losses"][s] - block["losses"][s])
                / abs(block["losses"][s])
                for r in ("none", "dots") for s in range(1, REMAT_STEPS + 1))
    if worst > TRAIN_RESUME_RTOL or not all(
            np.isfinite(runs[r]["losses"][s]) for r in runs
            for s in range(1, REMAT_STEPS + 1)):
        raise AssertionError(f"remat policies: losses differ by {worst:.3e}"
                             f" relative (tolerance {TRAIN_RESUME_RTOL})")
    # the forward and backward passes alone, on the trained parameters and
    # the cell's first batch: a step's peak may be the optimizer's
    args = train._parser().parse_args(argv)
    cfg = get_any_config(LM_ARCH)
    if "--reduced" in TRAIN_EXTRA_ARGS:
        cfg = cfg.reduced()
    batch = next(train._batches(args, cfg, torch.device(DEV))(0))
    parts = []
    for remat in ("none", "block", "dots"):
        ms = statistics.median(runs[remat]["step_s"][2:]) * 1e3
        kept, peak = passes_memory(cfg, params, batch, remat)
        parts.append(f"{remat} {ms:.1f} ms a step, max_memory_allocated "
                     f"{gb(peaks.get(remat))} above the run's start; the "
                     f"passes alone keep {gb(kept)} from forward to "
                     f"backward, peak {gb(peak)} above the parameters")
    say(f"train {LM_ARCH} by remat policy (steps 3-{REMAT_STEPS}, median, "
        "synchronised): " + "; ".join(parts) + f"; losses within "
        f"{worst:.3e} relative of block's (tolerance {TRAIN_RESUME_RTOL})")


def gb(n) -> str:
    return "not measured" if n is None else f"{n / 1e9:.3f} GB"


def passes_memory(cfg, params, batch, remat: str):
    """(bytes the forward pass keeps for the backward pass, the peak of
    both) of the training loss under ``remat``, above what was allocated
    before; ``(None, None)`` off the card."""
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import model as M
    from repro_torch.models.convert import unstack
    from repro_torch.train.tree import leaves, tree_map

    if DEV != "cuda":
        return None, None
    pcfg = ParallelConfig(compute_dtype="bfloat16", remat=remat)
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss, _ = M.train_loss(cfg, pcfg, unstack(ps), batch)
    sync()
    kept = torch.cuda.memory_allocated() - base
    grads = torch.autograd.grad(loss, leaves(ps))
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    del loss, grads, ps
    return kept, peak


# -- phase 10: the mesh, compression, the sequence-sharded decode core and
# the dry run ------------------------------------------------------------------

MESH_TRAIN_STEPS = 6
MESH_LOSS_TOL = 1e-3              # bf16: the meshed losses against unmeshed
# 10b: a float32 gradient tree shaped like zamba2-1.2b's parameters
COMPRESS_ARCH = ZAMBA_ARCH
COMPRESS_VALUES = 1178699904
# 10c: (tag, B, query heads, KV heads, head dim, keys) of the decode step
# after a 1024-token prompt and 32 new tokens: deepseek-v2-lite's MLA (16
# heads of q/k width 192) and radar-lm's (12 / 4 of 64)
DECODE_CORE_SHAPES = (("deepseek", 8, 16, 16, 192, 1056),
                      ("lm", 8, 12, 4, 64, 1056))
DECODE_CORE_CHUNKS = 4
DECODE_CORE_TOL = 2e-5
# 10d: the dry run's cells on the H100 production meshes (fake groups of
# 256 and 512), then one cell for real at world 1, its global batch cut
# from 256 to what fits one card
DRY_CELLS = (("llama3.2-1b", "train_4k"),
             ("deepseek-v2-lite-16b", "prefill_32k"),
             ("deepseek-v2-lite-16b", "decode_32k"),
             ("llama4-maverick-400b-a17b", "decode_32k"),
             ("zamba2-1.2b", "long_500k"))
DRY_REAL = ("llama3.2-1b", "train_4k")
DRY_REAL_BATCH = 2
DRY_REAL_STEPS = 3
DRY_TIMEOUT_S = 400


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_group(backend: str) -> None:
    """A process group of one on this process (NCCL on the card): a
    failure to start raises, nothing falls back."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    if dist.get_backend() != backend:
        raise AssertionError(f"process group backend {dist.get_backend()}, "
                             f"asked for {backend}")


def drive_mesh_path(archive, data: str, rows) -> None:
    """10a: ``launch.train --model-axis 1`` on a ``(data, model) = (1, 1)``
    mesh over an NCCL group of one, radar-lm-100m at full width on phase
    9's data and seed, its losses within ``MESH_LOSS_TOL`` of the same
    steps with no mesh and the same kernel launches (none: training runs
    the blocked core); the same with ``--microbatches 2`` (each cut from
    the global rows, then shared out over the data ranks), its losses
    bitwise the unmeshed run's; then the archive prompts served through the kernel
    route with DTensor parameters laid out by ``param_shardings``, greedy
    tokens and launches equal to the same engine on plain parameters."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_any_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import param_shardings
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.convert import to_reference, unstack
    from repro_torch.serve import Engine, Request

    backend = "nccl" if DEV == "cuda" else "gloo"
    start_group(backend)
    try:
        argv = ["--arch", LM_ARCH, "--steps", str(MESH_TRAIN_STEPS),
                "--data", data, "--device", DEV, "--log-every", "5",
                *TRAIN_EXTRA_ARGS]
        # one microbatch, then two: the microbatches cut from the global
        # rows before the data ranks share them (at world 1 the meshed
        # run takes that path and must give the unmeshed bits)
        for n_mb in (1, 2):
            runs, launched = {}, {}
            mb = ["--microbatches", str(n_mb)] if n_mb > 1 else []
            for tag, extra in (("unmeshed", []), ("mesh (1, 1)",
                                                  ["--model-axis", "1"])):
                reset_launches()
                runs[tag] = train.main(argv + mb + extra)
                launched[tag] = read_launches()
            a, b = runs["unmeshed"], runs["mesh (1, 1)"]
            worst = max(abs(a["losses"][s] - b["losses"][s])
                        for s in range(1, MESH_TRAIN_STEPS + 1))
            tol = MESH_LOSS_TOL if n_mb == 1 else 0.0
            if worst > tol or launched["unmeshed"] != \
                    launched["mesh (1, 1)"]:
                raise AssertionError(
                    f"mesh train, {n_mb} microbatch(es): losses differ by "
                    f"{worst} (tolerance {tol}); launches {launched}")
            leaf = b["state"].params["final_norm"]["scale"]
            if type(leaf).__name__ != "DTensor":
                raise AssertionError("the meshed run's state is not "
                                     "DTensors")
            ms = {tag: statistics.median(r["step_s"][2:]) * 1e3
                  for tag, r in runs.items()}
            say(f"mesh train {LM_ARCH} (--model-axis 1, {backend} group of "
                f"1, mesh {leaf.device_mesh}, {n_mb} microbatch"
                f"{'es' if n_mb > 1 else ''}): {MESH_TRAIN_STEPS} steps, "
                f"losses within {worst:.3e} of the unmeshed run (tolerance "
                f"{tol}{', bitwise' if n_mb > 1 else ''}); median step "
                f"{ms['mesh (1, 1)']:.1f} ms against {ms['unmeshed']:.1f} "
                f"unmeshed (steps 3 on): DTensor host cost "
                f"{ms['mesh (1, 1)'] - ms['unmeshed']:.1f} ms a step; "
                f"kernel launches {launched['mesh (1, 1)']} both (blocked "
                "core)")
            del runs, a, b, leaf
            gc.collect()

        # serving with DTensor parameters: the kernels see local tensors
        cfg = get_any_config(LM_ARCH)
        mesh = make_host_mesh(1, device_type=DEV)
        dtype = torch.bfloat16 if DEV == "cuda" else torch.float32
        name = "bfloat16" if DEV == "cuda" else "float32"
        pcfg = ParallelConfig(compute_dtype=name, kv_cache_dtype=name,
                              remat="none", param_dtype=name)
        params = M.init_params(cfg, 0, device=DEV, dtype=dtype)
        ref = to_reference(params)
        dparams = unstack(distribute(
            ref, param_shardings(cfg, pcfg, ref, mesh), mesh))
        toks = lm_prompts(archive)
        reqs = [Request(p, max_new_tokens=LM_NEW_TOKENS) for p in toks]
        per_call = path_launches(cfg)
        outs, counts = {}, {}
        for tag, p in (("plain", params), ("DTensor", dparams)):
            eng = Engine(cfg, pcfg, p, max_len=LM_MAX_LEN, device=DEV)
            reset_launches()
            sync()
            t = time.perf_counter()
            out = eng.generate(reqs, seed=SEED)
            sync()
            wall = (time.perf_counter() - t) * 1e3
            counts[tag] = (read_launches(), read_routes())
            outs[tag] = np.stack([o.tokens for o in out])
            expect = expected_launches(per_call, "kernel", eng.decode_steps)
            if counts[tag][0] != expect:
                raise AssertionError(f"mesh serve {tag}: launches "
                                     f"{counts[tag][0]}, expected {expect}")
            say(f"mesh serve {LM_ARCH} {name} ({tag} parameters): "
                f"{len(reqs)} requests x {LM_NEW_TOKENS} tokens in "
                f"{wall:.1f} ms; launches by route {counts[tag][1]}")
        if not np.array_equal(outs["plain"], outs["DTensor"]) or \
                counts["plain"] != counts["DTensor"]:
            raise AssertionError("mesh serve: tokens or launches differ "
                                 "between DTensor and plain parameters")
        add_path_launches(rows, *counts["DTensor"])
        say(f"mesh serve: greedy tokens equal ({outs['plain'].size}), "
            f"launches equal; the kernels took the local shards (a DTensor "
            f"reaching a wrapper raises)")
        del params, ref, dparams, eng
        gc.collect()
        drive_compression()
    finally:
        dist.destroy_process_group()
        if DEV == "cuda":
            torch.cuda.empty_cache()


def drive_compression() -> None:
    """10b: the codecs over a float32 gradient tree shaped like
    zamba2-1.2b's parameters: encode and decode for int8 and bf16, and
    ``compress_with_feedback``, timed, on-wire MB; ``compressed_psum``
    through the process group (NCCL on the card) bitwise the codec round
    trip; the int8 codec on the card bitwise the same call on the CPU."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_any_config
    from repro_torch.distributed import compression as C
    from repro_torch.models.model import param_specs
    from repro_torch.train.tree import leaves_with_paths

    cfg = get_any_config(COMPRESS_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    grads = [(p, torch.randn(t.shape, generator=gen, device=DEV) * 1e-3)
             for p, t in leaves_with_paths(param_specs(cfg,
                                                           torch.float32))]
    n = sum(g.numel() for _p, g in grads)
    if DEV == "cuda" and n != COMPRESS_VALUES:
        raise AssertionError(f"{COMPRESS_ARCH} gradient tree: {n} values")

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    parts = []
    for codec in ("int8", "bf16"):
        enc, t_enc = timed(lambda: [C.encode(g, codec) for _p, g in grads])
        dec, t_dec = timed(lambda: [C.decode(e, codec) for e in enc])
        wire = sum(C.wire_bytes(e, codec) for e in enc)
        parts.append(f"{codec} encode {t_enc:.1f} ms, decode {t_dec:.1f} "
                     f"ms, {wire / 1e6:.1f} MB on the wire")
        # through the group: bitwise the round trip
        for (p, g), d in zip(grads, dec):
            got = C.compressed_psum(g, dist.group.WORLD, codec)
            if not torch.equal(got.view(torch.int32), d.view(torch.int32)):
                raise AssertionError(f"compressed_psum {codec} {p}: not "
                                     "the codec's round trip")
        del enc, dec
    tree = {p: g for p, g in grads}
    res = C.init_error_feedback(tree)
    (comp, res), t_fb = timed(lambda: C.compress_with_feedback(tree, res,
                                                               "int8"))
    (comp, res), t_fb2 = timed(lambda: C.compress_with_feedback(tree, res,
                                                                "int8"))
    finite = all(bool(torch.isfinite(r).all()) for r in res.values())
    del comp, res
    # the int8 codec on the card against the CPU, at the largest leaves
    big = sorted(grads, key=lambda pg: -pg[1].numel())[:3]
    for p, g in big:
        a, b = C.encode(g, "int8"), C.encode(g.cpu(), "int8")
        if not (torch.equal(a["q"].cpu(), b["q"]) and torch.equal(
                a["scale"].cpu().view(torch.int32),
                b["scale"].view(torch.int32))):
            raise AssertionError(f"int8 codec {p}: the card's bits differ "
                                 "from the CPU's")
    say(f"compression over a float32 gradient tree shaped like "
        f"{cfg.name}'s parameters ({n} values, {n * 4 / 1e9:.2f} GB, "
        f"{len(grads)} leaves) on {DEV}: " + "; ".join(parts)
        + f"; compress_with_feedback int8 {t_fb:.1f} ms, again with the "
        f"residual {t_fb2:.1f} ms (residual finite {finite}); "
        f"compressed_psum through the {dist.get_backend()} group of 1 "
        f"bitwise the codec round trip at every leaf (int8, bf16); the "
        f"int8 codec bitwise the CPU's at the {len(big)} largest leaves "
        f"({', '.join(p for p, _g in big)})")
    del grads, tree
    gc.collect()


def drive_decode_core(rows, peak_bw: float, card: str) -> None:
    """10c: ``attention_core(impl="flash_decode", n_chunks=4)`` at the
    decode shapes of deepseek-v2-lite's MLA and radar-lm, against the
    kernel route's ``decode`` (``csrc/flash_decode.cu``, its launches
    counted) and the blocked core, in float32 within ``DECODE_CORE_TOL``,
    at a full and a partly filled cache; each timed."""
    import torch
    from repro_torch.models.attention import attention_core

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    for tag, B, hq, hkv, d, keys in DECODE_CORE_SHAPES:
        q = torch.randn(B, hq, 1, d, generator=gen, device=DEV)
        k = torch.randn(B, hkv, keys, d, generator=gen, device=DEV)
        v = torch.randn(B, hkv, keys, d, generator=gen, device=DEV)
        errs = []
        for kv_len in (keys, keys - 15):
            def core(impl, kv_len=kv_len):
                return attention_core(q, k, v, causal=True, impl=impl,
                                      kv_len=kv_len,
                                      n_chunks=DECODE_CORE_CHUNKS)
            fd = core("flash_decode")
            reset_launches()
            kern = core("kernel")
            launched, routes = read_launches(), read_routes()
            if routes["flash_attention"]["decode"] != 1 or \
                    launched["flash_attention"] != 1:
                raise AssertionError(f"decode core {tag}: launches "
                                     f"{routes}")
            add_path_launches(rows, launched, routes)
            blocked = core("blocked")
            errs.append(compare(f"flash_decode {tag} vs kernel", fd, kern,
                                rtol=DECODE_CORE_TOL, atol=DECODE_CORE_TOL))
            errs.append(compare(f"flash_decode {tag} vs blocked", fd,
                                blocked, rtol=DECODE_CORE_TOL,
                                atol=DECODE_CORE_TOL))
        ms = {impl: time_cuda(lambda impl=impl: attention_core(
            q, k, v, causal=True, impl=impl, kv_len=keys,
            n_chunks=DECODE_CORE_CHUNKS)) if DEV == "cuda" else float("nan")
            for impl in ("flash_decode", "kernel", "blocked")}
        bound = (q.numel() * 2 + k.numel() + v.numel()) * 4 / peak_bw * 1e3
        say(f"decode core {tag} (B {B}, {hq}/{hkv} heads of {d}, {keys} "
            f"keys, float32, {card}): flash_decode n_chunks="
            f"{DECODE_CORE_CHUNKS} against the kernel's decode and the "
            f"blocked core max_abs_err {max(errs):.3e} (tolerance "
            f"{DECODE_CORE_TOL}, kv_len {keys} and {keys - 15}); ms "
            f"flash_decode {ms['flash_decode']:.4f}, kernel "
            f"{ms['kernel']:.4f}, blocked {ms['blocked']:.4f} (CUDA "
            f"events, median of 7 x 10); byte bound {bound:.4f}")


def start_dry_runs(work: str):
    """10d, host only: each of ``DRY_CELLS`` in a process of its own (its
    own fake process group; all five at once)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    env["CUDA_VISIBLE_DEVICES"] = ""           # the dry run touches no GPU
    procs = []
    for arch, shape in DRY_CELLS:
        log = open(os.path.join(work, f"dry-{arch}-{shape}.log"), "w")
        procs.append((arch, shape, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "both", "--out", work],
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs


def finish_dry_runs(procs, work: str) -> None:
    """Wait for the dry runs (killing any left at ``DRY_TIMEOUT_S``) and
    print each cell: peak bytes per device on both meshes, FLOPs,
    collective bytes by kind, the roofline's dominant term."""
    deadline = time.monotonic() + DRY_TIMEOUT_S
    failed = []
    for arch, shape, log, proc in procs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        path = os.path.join(work, f"{arch}__{shape}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            failed.append(f"{arch} {shape} (exit {proc.returncode})")
            continue
        rec = json.loads(open(path).read())
        if rec["status"] != "ok":
            failed.append(f"{arch} {shape}: {rec.get('error')}")
            continue
        pod, multi = rec["meshes"]["pod"], rec["meshes"]["multipod"]
        cost, roof = pod["cost"], pod["roofline"]
        coll = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                         cost["per_collective"].items() if v)
        say(f"dry run {arch} {shape}: peak per device "
            f"{pod['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB on "
            f"(32, 8) (parameters {pod['memory']['param_bytes_per_device'] / 2**30:.3f},"
            f" arguments {pod['memory']['argument_bytes_per_device'] / 2**30:.3f}), "
            f"{multi['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB on "
            f"(2, 32, 8)"
            + (f"; its layers keep "
               f"{pod['memory']['remat_kept_bytes_per_device'] / 2**30:.3f}"
               " GiB beyond their inputs from forward to backward on "
               "(32, 8)"
               if "remat_kept_bytes_per_device" in pod["memory"] else "")
            + f"; traced in {pod['trace_s']} and {multi['trace_s']} "
            f"s; FLOPs {cost['flops']:.4e} (model {pod['model_flops']:.4e},"
            f" useful {pod['useful_flops_ratio']:.3f}), HBM bytes "
            f"{cost['bytes_accessed']:.4e}, collective GB by kind "
            f"{{{coll}}}; roofline on 256 H100s: compute "
            f"{roof['t_compute_s'] * 1e3:.2f} ms, memory "
            f"{roof['t_memory_s'] * 1e3:.2f} ms, collective "
            f"{roof['t_collective_s'] * 1e3:.2f} ms, dominant "
            f"{roof['dominant']} (predictions, not measurements)")
    if failed:
        raise AssertionError(f"dry run cells failed: {failed}; logs in "
                             f"{work}")


def drive_dry_real(card: str) -> None:
    """10d on the card: ``DRY_REAL`` at world 1, its global batch cut to
    ``DRY_REAL_BATCH``: the dry run's trace of that cut cell (a fake group
    of one) predicts the peak bytes and the FLOPs of a step; then the
    same step runs for real on a mesh of one over an NCCL group of one,
    ``torch.cuda.max_memory_allocated`` and the step time measured."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import SHAPES
    from repro_torch.data import make_batch
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.launch.steps import build_cell, trace_cell
    from repro_torch.train import init_train_state

    arch, shape_name = DRY_REAL
    shape = dataclasses.replace(SHAPES[shape_name],
                                global_batch=DRY_REAL_BATCH)
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()        # the earlier phases' cached blocks
    with dryrun.fake_group(1):
        mesh = make_host_mesh(1, device_type="cpu")
        tr = trace_cell(build_cell(arch, shape, mesh), mesh)
    start_group("nccl" if DEV == "cuda" else "gloo")
    try:
        mesh = make_host_mesh(1, device_type=DEV)
        prog = build_cell(arch, shape, mesh)
        cfg, pcfg, ocfg = (prog.static[k] for k in ("cfg", "pcfg", "ocfg"))
        state = distribute(init_train_state(cfg, ocfg, pcfg, seed=SEED,
                                            device=DEV),
                           prog.in_shardings[0], mesh)
        batch = make_batch(cfg, shape.global_batch, shape.seq_len,
                           seed=1000, device=DEV)
        batch = distribute(batch, prog.in_shardings[1], mesh)
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        step_ms, losses = [], []
        with set_mesh(mesh):
            for _ in range(DRY_REAL_STEPS):
                sync()
                t = time.perf_counter()
                state, metrics = prog.fn(state, batch)
                losses.append(float(metrics["loss_total"]))
                step_ms.append((time.perf_counter() - t) * 1e3)
        peak = (torch.cuda.max_memory_allocated() if DEV == "cuda"
                else float("nan"))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"dry-run cell for real: losses {losses}")
        ms = statistics.median(step_ms[1:])
        say(f"dry run against the card ({card}): {arch} {shape_name} at "
            f"world 1, global batch cut from {SHAPES[shape_name].global_batch}"
            f" to {shape.global_batch} x {shape.seq_len} "
            f"({pcfg.n_microbatches} microbatch, remat {pcfg.remat}, "
            f"{pcfg.compute_dtype} compute): predicted peak "
            f"{tr.peak_bytes_per_device / 2**30:.2f} GiB (arguments "
            f"{tr.argument_bytes_per_device / 2**30:.2f}, step "
            f"{tr.temp_bytes_per_device / 2**30:.2f}) against "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; step "
            f"{ms:.1f} ms (median of steps 2-{DRY_REAL_STEPS}: "
            f"{', '.join(f'{x:.1f}' for x in step_ms)}), "
            f"{tr.flops:.4e} traced FLOPs a step = "
            f"{tr.flops / ms / 1e9:.1f} TFLOP/s; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}")
        del state, batch
    finally:
        dist.destroy_process_group()
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()


# the TPU kernel each hand-written kernel replaces (wrapper function)
# 8c-rec: zamba2-1.2b's Mamba-2 block at full width as the 8 ranks of a
# production mesh's ``model`` axis hold it (8 of the 64 heads each), one
# rank after another in this process, in bf16 (``chunk_tc``) and float32
# (``f32``); a prefill of B 8 x 1024 tokens from a zeroed state
def drive_mla_sequence_shards(cfg, mla, card: str) -> None:
    """8c-ep's decode step on a sequence-sharded latent cache, as the
    ``model`` ranks of a mesh run it (``decode_step(attn_impl=
    "flash_decode")``): deepseek-v2-lite's MLA block ``mla`` at full
    width (every head; ``wq``, ``w_uk``, ``w_uv`` and ``wo`` whole) in
    float32 and bf16, a latent cache of ``EP_SEQ_LEN`` positions filled
    from a seed up to ``kv_len - 1``, and the ``EP_RANKS`` ranks' shards
    of it in turn, with no process group: the shard that holds position
    ``kv_len - 1`` takes the new token (``attention.write_rows``), each
    expands all 16 heads over its positions below ``kv_len`` and no
    others (``attention.mla_shard_partials``), and the partials meet in
    ``attention.combine_shards``.  Held against the whole block's decode
    token (``apply_mla`` on the whole cache, ``flash_decode``) within
    ``EP_SEQ_TOL`` at each of ``EP_SEQ_KV``, the cache the shards wrote
    against the whole block's bit for bit; rank 0's transient peak bytes
    beside the whole block's."""
    import torch
    from repro_torch.models import attention

    B, L, n = EP_BATCH, EP_SEQ_LEN, EP_SEQ_LEN // EP_RANKS
    H = cfg.n_heads
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    x32 = torch.randn((B, 1, cfg.d_model), generator=gen, device=DEV)
    filled32 = {k: torch.randn((B, L, w), generator=gen, device=DEV)
                for k, w in (("latent", cfg.mla.kv_lora_rank),
                             ("k_rope", cfg.mla.qk_rope_head_dim))}
    expand = attention._mla_expand
    expanded = []

    def counting_expand(cfg_, p_, latent, k_rope, heads):
        expanded.append((heads, latent.shape[1]))
        return expand(cfg_, p_, latent, k_rope, heads)

    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        tol = EP_SEQ_TOL[tag]
        p = {k: v.to(dtype) for k, v in mla.items()}
        x = x32.to(dtype)
        for kv_len in EP_SEQ_KV:
            start = kv_len - 1
            pos = torch.full((B, 1), start, device=DEV)
            below = torch.arange(L, device=DEV)[None, :, None] < start
            base = {k: torch.where(below, c, 0).to(dtype)
                    for k, c in filled32.items()}
            whole_cache = {k: c.clone() for k, c in base.items()}
            want, whole_peak = peak_of(lambda: attention.apply_mla(
                cfg, p, x, pos, cache=whole_cache, cache_index=start,
                impl="flash_decode")[0])
            cache = {k: c.clone() for k, c in base.items()}
            with torch.inference_mode():
                q, latent, k_rope = attention.mla_project(cfg, p, x, pos)
            parts, peaks = [], []
            expanded.clear()
            attention._mla_expand = counting_expand
            try:
                t = time.perf_counter()
                for r in range(EP_RANKS):
                    shard = {k: c[:, r * n:(r + 1) * n]
                             for k, c in cache.items()}

                    def rank_step(r=r, shard=shard):
                        if r * n <= start < (r + 1) * n:
                            for k, rows in (("latent", latent),
                                            ("k_rope", k_rope)):
                                attention.write_rows(shard[k], rows,
                                                     start - r * n, 1)
                        return attention.mla_shard_partials(
                            cfg, p, q, shard["latent"], shard["k_rope"],
                            offset=r * n, kv_len=kv_len)
                    part, peak = peak_of(rank_step)
                    parts.append(part)
                    peaks.append(peak)
                with torch.inference_mode():
                    o = attention.combine_shards(
                        [torch.cat(t, dim=3) for t in zip(*parts)])
                    got = o.to(dtype).transpose(1, 2).reshape(B, 1, -1) \
                        @ p["wo"]
                sync()
                shards_s = time.perf_counter() - t
            finally:
                attention._mla_expand = expand
            want_expanded = [(H, max(0, min(n, kv_len - r * n)))
                             for r in range(EP_RANKS)]
            if expanded != want_expanded:
                raise AssertionError(
                    f"MLA sequence shards {tag} kv_len {kv_len}: the ranks "
                    f"expanded (heads, positions) {expanded}, want "
                    f"{want_expanded}")
            for k in cache:
                if not bits_equal(cache[k], whole_cache[k]):
                    raise AssertionError(
                        f"MLA sequence shards {tag} kv_len {kv_len}: the "
                        f"cache's {k} the shards wrote is not the whole "
                        f"block's bit for bit")
            err = compare(f"MLA sequence shards {tag} kv_len {kv_len}: the "
                          f"combined decode token vs the whole block's",
                          got, want, **tol)
            say(f"model-axis MLA sequence shards ({card}): deepseek-v2-lite "
                f"MLA block at full width, {tag}, B {B}, one decode token on "
                f"a latent cache of {L} positions at kv_len {kv_len}; "
                f"{EP_RANKS} ranks' shards of {n} positions in turn, each "
                f"expanding all {H} heads over its filled positions "
                f"({', '.join(str(e[1]) for e in expanded)}), the partials "
                f"combined: vs the whole block max_abs_err {err:.3e} (rtol "
                f"{tol['rtol']}, atol {tol['atol']}); the cache bit for bit;"
                f" transient peak bytes: rank 0 {peaks[0] / 2**30:.4f} GiB "
                f"(the largest rank {max(peaks) / 2**30:.4f}), whole block "
                f"{whole_peak / 2**30:.4f}; the {EP_RANKS} ranks in turn "
                f"{shards_s:.3f} s")
            del want, whole_cache, cache, parts, o, got, base
    say(f"model-axis MLA sequence shards: {time.perf_counter() - t0:.2f} s")


REC_RANKS = 8
REC_BATCH, REC_PROMPT = 8, 1024
# float32: the same sums over ``model`` as 8c-ep's.  bf16: the whole
# block rounds one product over 4096 channels to bf16, the shards 8
# products over 512 each (summed here in float32), and the narrowed
# projection's bf16 outputs may round apart, carried through the scan; a
# few bf16 steps (2**-8 of the output's magnitude, about 2) apart
REC_TOL = {"float32": EP_TOL, "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def peak_of(fn):
    """``(fn(), the peak bytes allocated above the start while it ran)``
    (NaN off the card), under ``inference_mode``."""
    import torch

    sync()
    base = torch.cuda.memory_allocated() if DEV == "cuda" else 0
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = fn()
    sync()
    peak = (torch.cuda.max_memory_allocated() - base if DEV == "cuda"
            else float("nan"))
    return out, peak


def drive_recurrent_parallel(rows, card: str, peak_bw: float,
                             peak_tc: float) -> None:
    """8c-rec: one Mamba-2 block of zamba2-1.2b at full width, from a
    seed, in bf16 and in float32.  Each of the ``REC_RANKS`` ranks' shards
    (``sharding.model_shard``: the z, x and dt columns of ``w_in`` and the
    x channels of ``conv`` of its 8 heads, ``B`` and ``C`` whole, its rows
    of ``w_out``) computes in turn with no process group, on the kernel
    route, over a B 8 x 1024 prefill from a zeroed state of its own
    (``ssm.mamba2_mix``: ``mamba2_scan`` at 8 heads, counted).  The gated
    norm divides by the root mean square over every rank's channels, so
    the ranks' sums of squares are summed first, then each rank's
    ``layers.rms_project`` and the partial outputs summed: the block's
    own two steps, around what its ``sum_over_model`` and
    ``reduce_from_model`` sum on a mesh.  The sum is held against the
    whole block (``ssm.apply_mamba2``) within ``REC_TOL``, each rank's
    heads of the new state against the whole's; rank 0's scan against
    its plain versions at 8 heads and timed beside the whole block's at
    64; one rank's transient peak bytes beside the whole block's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import model_shard
    from repro_torch.kernels import mamba2_scan, ops, ref
    from repro_torch.models import ssm
    from repro_torch.models.layers import rms_project

    cfg = get_config(ZAMBA_ARCH)
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    P, N = s.head_dim, s.d_state
    H = d_inner // P
    hl = H // REC_RANKS
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    base = {k: v.detach() for k, v in ssm.init_mamba2(
        cfg, gen, torch.float32, DEV).items()}
    B, S = REC_BATCH, REC_PROMPT
    x32 = torch.randn((B, S, cfg.d_model), generator=gen, device=DEV)
    scan = ops.mamba2_scan
    calls = []

    def recording(*args, h0=None):
        # the start state as it was: the block writes the new one over it
        calls.append((args, None if h0 is None else h0.clone()))
        return scan(*args, h0=h0)

    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        tol = REC_TOL[tag]
        which = "chunk_tc" if dtype == torch.bfloat16 else "f32"
        # every leaf in the compute dtype, as compute_params casts the
        # stacked tree's
        p = {k: v.to(dtype) for k, v in base.items()}
        x = x32.to(dtype)

        def whole():
            state = ssm.init_mamba2_state(cfg, B, DEV)
            return ssm.apply_mamba2(cfg, p, x, state=state,
                                    impl="kernel")[0], state

        calls.clear()
        ops.mamba2_scan = recording
        try:
            (want, want_state), whole_peak = peak_of(whole)
            whole_args = calls[0]
            calls.clear()
            reset_launches()
            t = time.perf_counter()
            ranks = []
            for r in range(REC_RANKS):
                shard = model_shard(p, r, REC_RANKS)

                def mix(shard=shard, off=r * hl):
                    state = ssm.init_mamba2_state(cfg, B, DEV)
                    yf, sq, _ = ssm.mamba2_mix(cfg, shard, x, state=state,
                                               impl="kernel", head_offset=off)
                    return yf, sq, state
                (yf, sq, state), peak = peak_of(mix)
                ranks.append([shard, yf, sq, state, peak])
            sq = sum(rank[2] for rank in ranks)
            out = torch.zeros_like(want, dtype=torch.float32)
            for rank in ranks:
                shard, yf = rank[:2]
                part, peak = peak_of(lambda: rms_project(
                    yf, sq, d_inner, shard["norm_scale"], shard["w_out"],
                    dtype))
                out += part.float()
                rank[4] = max(rank[4], peak)
            shards_s = time.perf_counter() - t
        finally:
            ops.mamba2_scan = scan
        launched, routes = read_launches(), read_routes()
        if launched["mamba2_scan"] != REC_RANKS or \
                routes["mamba2_scan"][which] != REC_RANKS:
            raise AssertionError(f"Mamba-2 shards {tag}: mamba2_scan "
                                 f"launches {launched['mamba2_scan']}, by "
                                 f"route {routes['mamba2_scan']}; want "
                                 f"{REC_RANKS} on {which}")
        add_path_launches(rows, launched, routes)
        err = compare(f"Mamba-2 shards {tag}: combined vs the whole block",
                      out, want, **tol)
        serr = 0.0
        for r, rank in enumerate(ranks):
            heads, cols = (slice(r * hl, (r + 1) * hl),
                           slice(r * hl * P, (r + 1) * hl * P))
            state = rank[3]
            serr = max(serr, compare(
                f"Mamba-2 shards {tag}: rank {r}'s heads of the state",
                state["ssm"][:, heads], want_state["ssm"][:, heads],
                **SSM_TOL))
            for c in (cols, slice(d_inner, None)):
                serr = max(serr, compare(
                    f"Mamba-2 shards {tag}: rank {r}'s conv window",
                    state["conv"][..., c], want_state["conv"][..., c],
                    **SSM_TOL))

        # rank 0's scan (8 heads, x a strided slice of the fused
        # projection) against its plain versions, and timed beside the
        # whole block's (64 heads); these launches count on no path
        args, h0 = calls[0]
        got = ops.mamba2_scan(*args, h0=h0, mode="kernel")
        ytol = SSM_TOL if dtype == torch.float32 else SSM_BF16_Y_TOL
        kerr = 0.0
        for label, plain in (
                ("the recurrence", ref.mamba2_scan(*args, h0=h0)),
                ("mamba2_scan_chunks", ref.mamba2_scan_chunks(*args,
                                                               h0=h0))):
            kerr = max(kerr, compare(
                f"mamba2_scan {which} at {hl} heads vs {label} y", got[0],
                plain[0], **ytol), compare(
                f"mamba2_scan {which} at {hl} heads vs {label} state",
                got[1], plain[1], **SSM_TOL))
        ms = {name: time_cuda(lambda a=a, h=h: ops.mamba2_scan(
            *a, h0=h, mode="kernel")) if DEV == "cuda" else float("nan")
            for name, (a, h) in (("8", (args, h0)), ("64", whole_args))}
        plain_ms = time_cuda(lambda: ref.mamba2_scan(*args, h0=h0), reps=2,
                             inner=1) if DEV == "cuda" else float("nan")
        nbytes, nops = ssd_cost(B, S, hl, P, N, x.element_size(), True)
        # the tensor cores' bound, three bf16 products a float32 one as
        # rows 6a and 6c count them
        bound = max(nbytes / peak_bw, (3 if dtype == torch.float32 else 1)
                    * nops / peak_tc) * 1e3
        say(f"model-axis Mamba-2 shards ({card}): zamba2-1.2b block at full "
            f"width, {tag}, B {B} x {S} prefill from a zeroed state; "
            f"{REC_RANKS} ranks' shards ({hl} of {H} heads each) in turn: "
            f"combined output vs the whole block max_abs_err {err:.3e} "
            f"(rtol {tol['rtol']}, atol {tol['atol']}), each rank's heads of "
            f"the new state and conv window {serr:.3e} (SSM_TOL); "
            f"mamba2_scan {launched['mamba2_scan']} launches on {which}; "
            f"rank 0's scan at {hl} heads vs the recurrence and "
            f"mamba2_scan_chunks {kerr:.3e}, {ms['8']:.4f} ms (CUDA "
            f"events; the whole block's at {H} heads {ms['64']:.4f}; plain "
            f"at {hl} heads {plain_ms:.4f}; bound {bound:.4f}, "
            f"{nbytes / 1e6:.2f} MB, {nops / 1e9:.2f} GFLOP); transient peak bytes: rank 0 "
            f"{ranks[0][4] / 2**30:.3f} GiB (the largest rank "
            f"{max(rank[4] for rank in ranks) / 2**30:.3f}), whole block "
            f"{whole_peak / 2**30:.3f}; the {REC_RANKS} ranks in turn "
            f"{shards_s:.2f} s")
        del ranks, out, want, want_state, p, x, calls[:]
    del base, x32
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()


# 8c-gqa: a GQA attention block at full width as the 8 ranks of a
# production mesh's ``model`` axis hold it in a serving prefill (4 of 32
# query heads each), one rank after another in this process, in bf16
# (``tc_prefill``) and float32 (``f32``); a prefill of B 8 x 1024 tokens
# into each rank's heads of one cache of 1056 positions, then one decode
# token on the filled cache
GQA_RANKS = 8
GQA_BATCH, GQA_PROMPT, GQA_LEN = 8, 1024, 1056
# zamba2's shared block (32 of 32 heads of 64), llama's (32 query and 8
# KV heads of 64)
GQA_ARCHS = (ZAMBA_ARCH, "llama3.2-1b")
# float32: the same sums over ``model`` as 8c-ep's.  bf16: the whole
# block rounds one product over 2048 channels to bf16, the shards 8
# products over 256 each (summed here in float32): a few bf16 steps of
# outputs near 1 apart, as 8c-rec's
GQA_TOL = REC_TOL
# the cache the shards fill against the whole block's: bit for bit in
# bf16; in float32 cuBLAS sums the rank's 256- or 64-column projection in
# another order than the whole 2048- or 512-column one (on the card the
# narrow product alone differs from the whole one's columns, by up to
# 2.3e-6), so there the keys and values are held as float32 sums of 2048
# products
GQA_F32_CACHE_TOL = dict(rtol=1e-5, atol=1e-5)


def drive_attention_parallel(rows, card: str, peak_bw: float,
                             peak_flops: float, peak_tc: float) -> None:
    """8c-gqa: zamba2-1.2b's shared attention block and llama3.2-1b's
    attention block at full width, from a seed, in bf16 and in float32.
    Each of the ``GQA_RANKS`` ranks' shards (``sharding.model_shard``: the
    columns of ``wq``, ``wk`` and ``wv`` and the rows of ``wo`` of its
    heads) computes in turn with no process group, on the kernel route,
    over a B 8 x 1024 prefill that writes its heads' slice of one cache
    of ``GQA_LEN`` positions (``flash_attention`` at Hq/8 heads, counted),
    then one decode token on that cache (its ``decode`` kernel, counted).
    The partial outputs' sum is held against the whole block's within
    ``GQA_TOL``, and the cache the shards filled against the whole
    block's: bit for bit in bf16, within ``GQA_F32_CACHE_TOL`` in
    float32.  Rank 0's prefill kernel is held against its plain
    version and timed beside the whole block's and SDPA's at its heads,
    its decode kernel the same beside SDPA; one rank's transient peak
    bytes beside the whole block's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import model_shard
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention

    B, S, L = GQA_BATCH, GQA_PROMPT, GQA_LEN
    fa = ops.flash_attention
    calls = []

    def recording(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return fa(q, k, v, **kw)

    for arch in GQA_ARCHS:
        cfg = get_config(arch)
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        n = Hkv // GQA_RANKS
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        base = {k: v.detach() for k, v in attention.init_attn(
            cfg, gen, torch.float32, DEV).items()}
        x32 = torch.randn((B, S + 1, cfg.d_model), generator=gen, device=DEV)
        pos = torch.arange(S + 1, device=DEV).expand(B, S + 1)
        for dtype in (torch.bfloat16, torch.float32):
            tag = str(dtype).split(".")[-1]
            tol = GQA_TOL[tag]
            which = "tc_prefill" if dtype == torch.bfloat16 else "f32"
            p = {k: v.to(dtype) for k, v in base.items()}
            x = x32.to(dtype)

            def block(params, cache):
                """The prefill's and the decode token's outputs."""
                return [attention.apply_attn(
                    cfg, params, x[:, a:b], pos[:, a:b], cache=cache,
                    cache_index=a, impl="kernel")[0]
                    for a, b in ((0, S), (S, S + 1))]

            want_cache = attention.init_kv_cache(cfg, B, L, dtype, DEV)
            want, whole_peak = peak_of(lambda: block(p, want_cache))
            cache = attention.init_kv_cache(cfg, B, L, dtype, DEV)
            sums = [torch.zeros_like(o, dtype=torch.float32) for o in want]
            peaks = []
            reset_launches()
            t = time.perf_counter()
            for r in range(GQA_RANKS):
                shard = model_shard(p, r, GQA_RANKS)
                heads = {k: c[:, r * n:(r + 1) * n] for k, c in cache.items()}
                outs, peak = peak_of(lambda: block(shard, heads))
                peaks.append(peak)
                for acc, o in zip(sums, outs):
                    acc.add_(o.float())
            shards_s = time.perf_counter() - t
            launched, routes = read_launches(), read_routes()
            split = routes["flash_attention"]
            if launched["flash_attention"] != 2 * GQA_RANKS or \
                    split[which] != GQA_RANKS or \
                    split["decode"] != GQA_RANKS:
                raise AssertionError(
                    f"GQA shards {arch} {tag}: flash_attention launches "
                    f"{launched['flash_attention']}, by route {split}; want "
                    f"{GQA_RANKS} on {which} and {GQA_RANKS} decodes")
            add_path_launches(rows, launched, routes)
            add_wide_launches(rows)
            errs = [compare(f"GQA shards {arch} {tag} {name}: their sum vs "
                            f"the whole block", got, ref_o, **tol)
                    for name, got, ref_o in zip(("prefill", "decode"), sums,
                                                want)]
            apart = 0
            for k in ("k", "v"):
                if dtype == torch.bfloat16:
                    if not bits_equal(cache[k], want_cache[k]):
                        raise AssertionError(
                            f"GQA shards {arch} {tag}: the cache's {k} the "
                            f"shards filled is not the whole block's bit "
                            f"for bit")
                else:
                    compare(f"GQA shards {arch} {tag}: the cache's {k} the "
                            f"shards filled vs the whole block's", cache[k],
                            want_cache[k], **GQA_F32_CACHE_TOL)
                    apart += int((cache[k] != want_cache[k]).sum())
            filled = ("equals the whole block's bit for bit"
                      if dtype == torch.bfloat16 else
                      f"is within rtol {GQA_F32_CACHE_TOL['rtol']}, atol "
                      f"{GQA_F32_CACHE_TOL['atol']} of the whole block's "
                      f"({apart} of {2 * cache['k'].numel()} values apart)")

            # rank 0's prefill kernel (Hq/8 heads, its keys a strided
            # slice of the cache) against its plain version, timed beside
            # the whole block's; these launches count on no path
            calls.clear()
            ops.flash_attention = recording
            try:
                scratch = attention.init_kv_cache(cfg, B, L, dtype, DEV)
                with torch.inference_mode():
                    block(model_shard(p, 0, GQA_RANKS),
                          {k: c[:, :n] for k, c in scratch.items()})
                    block(p, scratch)
            finally:
                ops.flash_attention = fa
            rank0, whole_call = calls[0], calls[2]
            q, k, v, kw = rank0
            got = fa(q, k, v, mode="kernel", **kw)
            ktol = FA_F32_TOL if dtype == torch.float32 else FA_BF16_TOL
            kerr = compare(f"flash_attention {which} at {Hq // GQA_RANKS} "
                           f"heads vs its plain version", got,
                           ref.flash_attention(q, k, v, **kw), **ktol)
            ms = {name: time_cuda(lambda c=c: fa(c[0], c[1], c[2],
                                                 mode="kernel", **c[3]))
                  for name, c in (("rank", rank0), ("whole", whole_call))}
            plain_ms = time_cuda(lambda: ref.flash_attention(q, k, v, **kw),
                                 reps=2, inner=1)
            # SDPA at the rank's heads, the library time of rows 5a (bf16)
            # and 5c (float32, its kernel named); never called by the port
            sdpa_ms = time_cuda(lambda: sdpa(q, k, v, True))
            sdpa_kernel = (first_kernels(profiled_kernel_names(
                lambda: sdpa(q, k, v, True))) if dtype == torch.float32
                else None)
            nbytes, nops = attention_cost(B, q.shape[1], k.shape[1], S, S,
                                          q.shape[3], True, q.element_size())
            # the tensor cores' bound, three bf16 products a float32 one
            # as row 5c counts them
            bound = max(nbytes / peak_bw, (3 if dtype == torch.float32
                                           else 1) * nops / peak_tc) * 1e3
            # rank 0's decode call (8 of the phase's 32 decode launches are
            # this arch and dtype's, one a rank): its kernel against its
            # plain version, timed by events and the profiler beside SDPA,
            # bound as row 5b bounds it
            dq, dk, dv, dkw = calls[1]

            def dkern():
                return fa(dq, dk, dv, mode="kernel", **dkw)
            derr = compare(f"flash_attention decode at {Hq // GQA_RANKS} "
                           f"heads vs its plain version", dkern(),
                           ref.flash_attention(dq, dk, dv, **dkw), **ktol)
            dec = {"ms": time_cuda(dkern),
                   "device_ms": profiled_device_ms(dkern, "flash_decode"),
                   "plain_ms": time_cuda(
                       lambda: ref.flash_attention(dq, dk, dv, **dkw),
                       reps=3, inner=3),
                   "library_ms": time_cuda(lambda: sdpa(dq, dk, dv, True))}
            dbytes, dops = attention_cost(B, dq.shape[1], dk.shape[1], 1,
                                          dk.shape[2], dq.shape[3], True,
                                          dq.element_size())
            dec_bound = max(dbytes / peak_bw, dops / (
                peak_tc if dtype == torch.bfloat16 else peak_flops)) * 1e3
            say(f"model-axis GQA shards ({card}): {arch} attention block at "
                f"full width, {tag}, B {B} x {S} prefill into a cache of {L} "
                f"then 1 decode token; {GQA_RANKS} ranks' shards ({Hq // GQA_RANKS}"
                f" of {Hq} query and {n} of {Hkv} KV heads each) in turn: "
                f"summed against the whole block max_abs_err "
                f"{errs[0]:.3e} (prefill), {errs[1]:.3e} (decode) (rtol "
                f"{tol['rtol']}, atol {tol['atol']}); the cache they filled "
                f"{filled}; flash_attention "
                f"{launched['flash_attention']} launches ({split}); rank "
                f"0's {which} prefill at {Hq // GQA_RANKS} heads vs plain "
                f"{kerr:.3e}, {ms['rank']:.4f} ms (CUDA events; the whole "
                f"block's at {Hq} heads {ms['whole']:.4f}; plain at "
                f"{Hq // GQA_RANKS} heads {plain_ms:.4f}; SDPA at "
                f"{Hq // GQA_RANKS} heads {sdpa_ms:.4f}"
                f"{f' ({sdpa_kernel})' if sdpa_kernel else ''}; bound "
                f"{bound:.4f}, {nbytes / 1e6:.2f} MB, {nops / 1e9:.2f} "
                f"GFLOP); rank 0's decode at {Hq // GQA_RANKS} heads on "
                f"{dk.shape[2]} keys vs plain {derr:.3e}, events "
                f"{dec['ms']:.4f} ms, device {fmt_ms(dec['device_ms'])} "
                f"(plain {dec['plain_ms']:.4f}, SDPA "
                f"{dec['library_ms']:.4f}, bound {dec_bound:.4f}, "
                f"{dbytes / 1e6:.3f} MB); transient"
                f" peak bytes: rank 0 {peaks[0] / 2**30:.3f} GiB (the "
                f"largest rank {max(peaks) / 2**30:.3f}), whole block "
                f"{whole_peak / 2**30:.3f}; the {GQA_RANKS} ranks in turn "
                f"{shards_s:.2f} s")
            del want, want_cache, cache, scratch, sums, calls[:], p, x
        del base, x32, pos
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()


REPLACES = {
    "qvp_reduce": "src/repro/kernels/qvp_reduce.py:43",
    "zr_accum": "src/repro/kernels/zr_accum.py:44",
    "grid_map": "src/repro/kernels/grid_map.py:58",
    "grid_update": "src/repro/kernels/grid_update.py:59",
    "flash_attention": "src/repro/kernels/flash_attention.py:87",
    "mamba2_scan": "src/repro/kernels/mamba2_scan.py:74",
}
# the source of each route in a file of its own (the others:
# csrc/<name>.cu)
SOURCES = {"flash_attention:decode": "flash_decode",
           "mamba2_scan:decode": "mamba2_decode"}


def run_phases(peak_bw: float, peak_flops: float, peak_tc: float):
    """Phases 3 to 10; returns the per-kernel rows of the JSON line."""
    t_start = time.perf_counter()

    def elapsed(phase: str) -> None:
        say(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s")

    # 3. kernels against their plain versions
    rows = check_kernels(peak_bw, peak_flops)
    rows.update(check_grid_kernels(peak_bw, peak_flops))
    rows.update(check_flash_attention(peak_bw, peak_flops, peak_tc))
    rows.update(check_mamba2_scan(peak_bw, peak_flops, peak_tc))
    elapsed("3 (kernel check)")

    # 4. the paths
    work = ROOT / ".chip_smoke"
    work.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="archive-", dir=work)
    fed = tempfile.mkdtemp(prefix="federation-", dir=work)
    ing = tempfile.mkdtemp(prefix="ingest-", dir=work)
    dry = None
    try:
        archive, vcp, volumes, sim, site = build_archive(tmp)
        elapsed("4 (archive)")
        drive_main_path(archive, vcp, volumes, rows)
        del volumes
        drive_grid_path(archive, rows)
        elapsed("4 (QVP, QPE and grid paths)")
        # 5. end-to-end times
        # the grids at the host's cores only (their read at one reader is
        # QVP's and QPE's, cut for time)
        for workers in (1, os.cpu_count() or 1):
            time_products(archive, workers, reps=1)
        time_grid_products(archive, os.cpu_count() or 1, reps=1)
        time_store_layers(archive)
        elapsed("5 (times)")
        # 6. the incremental path, which appends to the archive
        drive_incremental_path(archive, vcp, sim, site, rows)
        elapsed("6 (incremental path)")
        # 6b. the federated path: two more sites and a catalog
        catalog, archives, sims = drive_federated_path(archive, vcp, fed,
                                                       rows)
        elapsed("6b (federated path)")
        # 6c. the same catalog served over HTTP
        drive_http_path(catalog, archives, sims, vcp, rows)
        elapsed("6c (archive HTTP service)")
        # 6d. KVNX's repository compacted, rolled back, swept, read remotely
        drive_maintenance_path(archive, rows)
        elapsed("6d (store maintenance)")
        del catalog, archives, sims
        # 6e. Raw2Zarr ingest of raw files, the DataTree view, the live feed
        ingested = drive_ingest_path(ing, rows)
        elapsed("6e (ingest and live feed)")
        # 7. the LM serve path, prompts drawn from the archive
        drive_lm_path(archive, rows)
        elapsed("7 (LM serve path)")
        # 8. the zamba2 serve path, the same prompts
        drive_zamba2_path(archive, rows)
        elapsed("8 (zamba2 serve path)")
        # 8b. the stablelm-3b serve path (head dim 80), the same prompts
        drive_stablelm_path(archive, rows)
        elapsed("8b (stablelm-3b serve path)")
        # 8c. the DeepSeek serve path (MLA at D = 192, the MoE FFN)
        drive_deepseek_path(archive, rows)
        elapsed("8c (deepseek-v2-lite-16b serve path)")
        # 8c-ep. its MLA and MoE blocks as the model axis's 8 ranks hold them
        drive_expert_parallel(rows, card_line())
        elapsed("8c-ep (deepseek's model-axis shards)")
        # 8c-rec. zamba2's Mamba-2 block as the model axis's 8 ranks hold it
        drive_recurrent_parallel(rows, card_line(), peak_bw, peak_tc)
        elapsed("8c-rec (zamba2's Mamba-2 model-axis shards)")
        # 8c-gqa. zamba2's and llama's GQA blocks as the 8 ranks hold them
        drive_attention_parallel(rows, card_line(), peak_bw, peak_flops,
                                 peak_tc)
        elapsed("8c-gqa (GQA model-axis shards)")
        # 8d. the xLSTM serve path (mLSTM and sLSTM, no hand kernel)
        drive_xlstm_path(archive, rows)
        elapsed("8d (xlstm-1.3b serve path)")
        # 9. training on the ingested archive, a checkpoint, serving it
        drive_train_path(ingested, ing, rows)
        elapsed("9 (train, checkpoint, serve path)")
        # 10a-b. the mesh at world 1: training and serving through it;
        # gradient compression through the group
        drive_mesh_path(archive, ingested, rows)
        elapsed("10a-b (mesh train and serve, compression)")
        # 10d's dry runs (host only) beside 10c on the card
        dry = tempfile.mkdtemp(prefix="dryrun-", dir=work)
        procs = start_dry_runs(dry)
        try:
            drive_decode_core(rows, peak_bw, card_line())
        except BaseException:
            for *_cell, log, proc in procs:
                proc.kill()
                proc.wait()
                log.close()
            raise
        elapsed("10c (sequence-sharded decode core)")
        finish_dry_runs(procs, dry)
        elapsed(f"10d (dry run of {len(DRY_CELLS)} cells)")
        drive_dry_real(card_line())
        elapsed("10d (the cut cell on the card)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(fed, ignore_errors=True)
        shutil.rmtree(ing, ignore_errors=True)
        if dry is not None:
            shutil.rmtree(dry, ignore_errors=True)

    say("library_ms: F.scaled_dot_product_attention for flash_attention, "
        "Tensor.index_add_ for grid_update at the QPE fold (timed beside "
        "them, never called by the port); null for the others: no single "
        "PyTorch call computes a quality-masked azimuthal mean, a Z-R "
        "integral, a masked weighted mean over a gather map or an SSD "
        "(Mamba-2) scan")
    say("launches: summed over the counted runs of every path that "
        "launches the kernel (the serve paths: their bfloat16 generate, of "
        "radar-lm, zamba2, stablelm-3b and deepseek-v2-lite; the federated "
        "path: one launch "
        "per repository of each counted run; the HTTP path: each cold "
        "product, the 8 coalesced QVP requests counting one; the "
        "maintenance path: each QVP; the ingest path: its QVP, QPE and "
        "each incremental CAPPI; the train path: serving its checkpoint); "
        "flash_attention and "
        "mamba2_scan are the wrappers, their calls split by route in "
        "'routes', with the numbers "
        "of the route their path takes (tc_prefill at radar-lm's shape, "
        "chunk_tc at zamba2's); <wrapper>:<route> is each of their kernels "
        "(flash_attention's at radar-lm's shapes), the f32 routes' launches "
        "from the float32 kernel-route generate (the bf16 path never takes "
        "them); grid_update's numbers are at the QPE fold, 89% wet; "
        "device_ms is a torch.profiler time and host_us the wrapper's host "
        "time per call, where measured; deepseek is each flash_attention "
        "route at DeepSeek-V2-Lite's MLA shape (16 heads of 192), "
        "wide the wide prefill kernel of the route at stablelm's shape above "
        "D 256 (launches: the route's calls that took it), boundary it and "
        "the narrow kernel in turns at D 192 and 256, wide_p_tiled the wide "
        "scan beside the prefill routes of its dtype")
    idle = [k for k, row in rows.items() if not row.get("launches")]
    if idle:
        raise AssertionError(f"no path launched {idle}")
    out = []
    for kname, row in rows.items():
        source = SOURCES.get(kname, kname.split(":")[0])
        out.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": REPLACES[kname.split(":")[0]],
            "launches": row["launches"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
        })
        for key in ("routes", "device_ms", "warm_device_ms", "cold_ms",
                    "host_us", "warm_ms",
                    "cuda_core_bound_ms", "library_kernel", "deepseek",
                    "wide", "boundary", "wide_p_tiled"):
            if row.get(key) is not None:
                out[-1][key] = row[key]
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the "
              "GPU only", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak_bw, peak_flops, peak_tc = card_peaks(name)
    say(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} device(s))")

    # 2. build
    t = time.perf_counter()
    logs = _cuda.build()
    BUILD_LOGS.update(logs)
    say(f"build: {len(logs)} kernel(s) compiled in parallel in "
        f"{time.perf_counter() - t:.1f} s into {_cuda.BUILD_DIR}")
    for kname, log in logs.items():
        for line in log.splitlines():
            # registers and spills, errors, and ptxas' wgmma notes (C75xx:
            # a serialized or waited tensor-core pipeline)
            if ("registers" in line or "error" in line.lower()
                    or "(C75" in line):
                say(f"build {kname}: {line.strip()}")

    kernels = run_phases(peak_bw, peak_flops, peak_tc)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
