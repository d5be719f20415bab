#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines:

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) into the package's
   ``kernels/build/`` directory;
3. kernel check: each kernel against its plain PyTorch version on the
   card, at the paths' shapes and at ragged ones (``qvp_reduce`` and
   ``zr_accum`` with the tolerances of the reference package's kernel
   tests, ``grid_map`` and ``grid_update`` bitwise), and twice for bitwise
   stability;
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
      request with ``mode="ref"`` on the card;
5. times: each kernel (CUDA events, median) beside its plain version and
   its bound, and each product end to end, split into store read and
   decode, host-to-device copy, kernel, and device-to-host copy;
6. the incremental path (last, since it appends to the archive):
   incremental CAPPI, column-max and QPE states built at the archive's
   head, then 3 scans appended one commit each; after each append every
   state catches up and is held bitwise against the from-scratch product
   at that head.

It prints a JSON line of per-kernel numbers, the card line again, and as
its last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without a CUDA device it exits non-zero before any result.
"""

from __future__ import annotations

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
N_APPEND = 3                      # scans the incremental path appends
T0 = 1305849600.0                 # 2011-05-20, the paper's KVNX case
SEED = 0
VCP_NAME = "VCP-212"
# where the paths run; a rehearsal on a machine without a card sets it
# to "cpu" and stands the plain versions in for the kernels
DEV = "cuda"

# published peaks (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s and float32 FLOP/s outside the tensor cores.
# Matched against the card's name in this order.
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
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
    for key, bw, flops in CARD_PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peaks for card {name!r}")


# -- comparisons --------------------------------------------------------------

def compare(name, got, want, *, rtol, atol) -> float:
    """Assert ``got`` ~ ``want`` (NaN where the other is NaN); returns the
    largest absolute difference over finite entries."""
    import torch

    got = got.float().cpu()
    want = want.float().cpu()
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
    # bytes: dbz and dt read once, accumulation written once; operations:
    # per gate clip (2), 2 divisions, 2 powers (one each), mask (2),
    # weight division, multiply, add
    z["bytes"] = n * 4 + T * 4 + A * R * 4
    z["ops"] = 11 * n
    for name, row in rows.items():
        t_bytes = row["bytes"] / peak_bw * 1e3
        t_ops = row["ops"] / peak_flops * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        say(f"time {name} {main_shape}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: {row['bytes'] / 1e9:.3f} GB, "
            f"{row['ops'] / 1e9:.3f} Gop), "
            f"{row['bytes'] / row['ms'] / 1e6:.1f} GB/s achieved")
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
    return bool(torch.equal(nan, torch.isnan(want))
                and torch.equal(got[~nan].view(torch.int32),
                                want[~nan].view(torch.int32)))


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


def check_grid_kernels(peak_bw: float, peak_flops: float):
    """grid_map and grid_update against their plain versions, bitwise, at
    the grid and incremental paths' shapes and at ragged ones; then timed
    at the main shapes."""
    import torch
    from repro_torch.core import fm301
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    A, R = fm301.VCPS[VCP_NAME].n_azimuth, fm301.VCPS[VCP_NAME].n_gates
    G = len(ELEVATIONS) * A * R
    rows = {}

    def check_twice(name, fn, plain):
        """Kernel twice (bitwise stable) and bitwise equal to the plain
        version; returns the result and the measured max |difference|."""
        got, again = fn(), fn()
        if DEV == "cuda":
            torch.cuda.synchronize()
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

    # grid_map ---------------------------------------------------------------
    field = radar_field((N_SCANS, G), gen)
    maps = grid_maps()
    for label, mp in maps.items():
        idx = torch.from_numpy(np.array(mp.gate_idx)).to(DEV)
        w = torch.from_numpy(np.array(mp.weights)).to(DEV)
        _, err = check_twice(
            f"grid_map {label} T={N_SCANS} G={G} C={idx.shape[0]} "
            f"k={idx.shape[1]}",
            lambda: ops.grid_map(field, idx, w, mode="kernel"),
            lambda: ref.grid_map(field, idx, w))
        if label.endswith("nearest"):
            rows["grid_map"] = dict(field=field, idx=idx, w=w,
                                    max_abs_err=err)
    for T, g, c, k in ((5, 3001, 777, 1), (3, 4000, 2999, 4),
                       (2, 1000, 513, 11), (1, 9, 1, 8)):
        f = radar_field((T, g), gen, nan_frac=0.2)
        # in range, past the end (NaN) and negative (wraps once)
        idx = torch.randint(-g - 5, g + 5, (c, k), generator=gen,
                            device=DEV, dtype=torch.int32)
        w = torch.rand((c, k), generator=gen, device=DEV) * 2.0
        w[torch.rand((c, k), generator=gen, device=DEV) < 0.3] = 0.0
        check_twice(f"grid_map ragged T={T} G={g} C={c} k={k}",
                    lambda: ops.grid_map(f, idx, w, mode="kernel"),
                    lambda: ref.grid_map(f, idx, w))
    empty = ops.grid_map(field[:0], rows["grid_map"]["idx"],
                         rows["grid_map"]["w"], mode="kernel")
    if tuple(empty.shape) != (0, rows["grid_map"]["idx"].shape[0]):
        raise AssertionError("grid_map: T=0 must give a (0, C) result")
    none = ops.grid_map(field[:2], torch.zeros((4, 0), dtype=torch.int32,
                                               device=DEV),
                        torch.zeros((4, 0), device=DEV), mode="kernel")
    if not torch.isnan(none).all():
        raise AssertionError("grid_map: k=0 must give NaN everywhere")
    say("check grid_map: T=0 gives (0, C), k=0 gives NaN")

    # grid_update -----------------------------------------------------------
    cappi = maps["cappi 240x240 nearest"]
    reach = torch.from_numpy(cappi.in_reach()).to(DEV)
    wet = torch.rand(A * R, generator=gen, device=DEV) < 0.3
    cases = {
        # the incremental grid rows: an all-NaN canvas, set where in reach
        "set": (torch.full((1, reach.numel()), float("nan"), device=DEV),
                reach),
        # the QPE fold: a non-negative accumulation, add where it rained
        "add": (torch.rand((1, A * R), generator=gen, device=DEV) * 50.0,
                wet),
        "max": (radar_field((3, 2999), gen, nan_frac=0.2),
                torch.rand(2999, generator=gen, device=DEV) < 0.5),
    }
    for op, (state, touched) in cases.items():
        pos = torch.full(touched.shape, -1, dtype=torch.int32, device=DEV)
        m = int(touched.sum())
        pos[touched] = torch.arange(m, dtype=torch.int32, device=DEV)
        upd = radar_field((state.shape[0], m), gen, nan_frac=0.0).abs()
        if op == "max":
            pos[torch.nonzero(touched)[0]] = m + 2      # reads NaN
        got, err = check_twice(
            f"grid_update {op} T={state.shape[0]} C={state.shape[1]} M={m}",
            lambda: ops.grid_update(state, upd, pos, op=op, mode="kernel"),
            lambda: ref.grid_update(state, upd, pos, op=op))
        keep = pos < 0
        if not torch.equal(got[:, keep].view(torch.int32),
                           state[:, keep].view(torch.int32)):
            raise AssertionError(f"grid_update {op}: untouched cells changed")
        if op != "max":
            rows[f"grid_update {op}"] = dict(state=state, upd=upd, pos=pos,
                                             max_abs_err=err)
    try:
        ops.grid_update(state, upd, pos, op="mul", mode="kernel")
    except ValueError as exc:
        say(f"check grid_update: unknown op raises ({exc})")
    else:
        raise AssertionError("grid_update: an unknown op must raise")

    # times at the main shapes ----------------------------------------------
    r = rows["grid_map"]
    T, C, k = N_SCANS, r["idx"].shape[0], r["idx"].shape[1]
    r["ms"] = time_cuda(lambda: ops.grid_map(r["field"], r["idx"], r["w"],
                                             mode="kernel"))
    r["plain_ms"] = time_cuda(lambda: ref.grid_map(r["field"], r["idx"],
                                                   r["w"]), reps=3, inner=2)
    live = int((r["w"] > 0).sum())
    # bytes: the map read once, the gathered values of live slots (a gate
    # is read only where its weight is > 0), the output written once;
    # operations: per slot test, two selects, multiply, two adds; per
    # output a compare, a max and a division
    r["bytes"] = C * k * 8 + T * live * 4 + T * C * 4
    r["ops"] = T * C * (6 * k + 3)
    r["shape"] = f"T={T} G={G} C={C} k={k}, {live} live slots"
    for op in ("set", "add"):
        u = rows[f"grid_update {op}"]
        Tu, Cu = u["state"].shape
        m = u["upd"].shape[1]
        u["ms"] = time_cuda(lambda: ops.grid_update(u["state"], u["upd"],
                                                    u["pos"], op=op,
                                                    mode="kernel"))
        u["plain_ms"] = time_cuda(lambda: ref.grid_update(
            u["state"], u["upd"], u["pos"], op=op))
        # bytes: state and pos read once, the touched update values
        # gathered once, the output written once; operations: a select
        # per element and, for add, an add per touched one
        u["bytes"] = Tu * Cu * 4 + Cu * 4 + Tu * m * 4 + Tu * Cu * 4
        u["ops"] = Tu * Cu + (Tu * m if op == "add" else 0)
        u["shape"] = f"T={Tu} C={Cu} M={m}"
    for name, row in rows.items():
        t_bytes = row["bytes"] / peak_bw * 1e3
        t_ops = row["ops"] / peak_flops * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        say(f"time {name} ({row['shape']}): kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: {row['bytes'] / 1e6:.3f} MB, "
            f"{row['ops'] / 1e9:.4f} Gop), "
            f"{row['bytes'] / row['ms'] / 1e6:.1f} GB/s achieved")
        for key in ("field", "idx", "w", "state", "upd", "pos"):
            row.pop(key, None)
    # the 600 x 600 IDW map: the heaviest gather the grid path can ask for
    idw = maps["cappi 600x600 idw"]
    idx = torch.from_numpy(np.array(idw.gate_idx)).to(DEV)
    w = torch.from_numpy(np.array(idw.weights)).to(DEV)
    ms = time_cuda(lambda: ops.grid_map(field, idx, w, mode="kernel"))
    live = int((w > 0).sum())
    nbytes = idx.numel() * 8 + N_SCANS * live * 4 + N_SCANS * idx.shape[0] * 4
    say(f"time grid_map cappi 600x600 idw (T={N_SCANS} C={idx.shape[0]} "
        f"k=4, {live} live slots): kernel {ms:.4f} ms, byte bound "
        f"{nbytes / peak_bw * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB)")
    # one row per kernel in the JSON line: grid_update at the QPE fold,
    # the larger of its two main shapes (the set row is printed above)
    rows["grid_update"] = rows.pop("grid_update add")
    del rows["grid_update set"]
    return rows


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
    from repro_torch.kernels import grid_map, grid_update, qvp_reduce, zr_accum

    return {"qvp_reduce": qvp_reduce, "zr_accum": zr_accum,
            "grid_map": grid_map, "grid_update": grid_update}


def reset_launches() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def read_launches():
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()
    return {k: m.launches for k, m in kernel_modules().items()}


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

GRID_LAUNCHES = {"ppi": 1, "cappi": 1, "column_max": len(ELEVATIONS)}


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
    bitwise against the same request on the plain version."""
    grid_launches = 0
    for product, launches in GRID_LAUNCHES.items():
        with archive.session() as session:
            reset_launches()
            t = time.perf_counter()
            got = grid_product(session, product)
            launched = read_launches()
            wall = time.perf_counter() - t
        say(f"grid path {product}: kernel launches {launched}, "
            f"{wall * 1e3:.1f} ms, {got.chunk_fetches} chunk payloads")
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
                dev = [(torch.from_numpy(h).to(DEV),
                        *grid._map_tensors(m.gate_idx, m.weights, DEV))
                       for h, m in zip(host, maps)]
                if DEV == "cuda":
                    torch.cuda.synchronize()
                t2 = time.perf_counter()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = grid._fmax_sweeps([ops.grid_map(*d) for d in dev])
                end.record()
                end.synchronize()
                t3 = time.perf_counter()
                res.cpu().numpy()
                t4 = time.perf_counter()
            split["read_ms"].append((t1 - t0) * 1e3)
            split["h2d_ms"].append((t2 - t1) * 1e3)
            split["kernel_ms"].append(start.elapsed_time(end))
            split["d2h_ms"].append((t4 - t3) * 1e3)
            del blocks, host, dev
        med = {k: statistics.median(v) for k, v in split.items()}
        say(f"time {product} read_workers={read_workers}: end-to-end "
            f"{med['e2e_ms']:.1f} ms = store read+decode (+stack) "
            f"{med['read_ms']:.1f} ms + host-to-device {med['h2d_ms']:.1f} ms "
            f"({mb:.0f} MB) + "
            f"kernels {med['kernel_ms']:.3f} ms ({len(maps)} grid_map"
            f"{' + fmax' if product == 'column_max' else ''}) + "
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
            rep = inc.update()
            launched = read_launches()
            t_update = time.perf_counter() - t
            update_launches += launched["grid_update"]
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
                f"scratch, launches {launched}, update {t_update * 1e3:.1f} ms"
                f" vs from scratch {t_full * 1e3:.1f} ms; bitwise equal to "
                "from scratch")
            if launched["grid_update"] < 1 or (
                    kind != "qpe" and launched["grid_map"] < 1):
                raise AssertionError(f"incremental {kind}: launches "
                                     f"{launched}")
        if step:
            noop = [inc.update().noop for inc in incs.values()]
            if not all(noop):
                raise AssertionError("a second update at one head must be "
                                     "a no-op")
    rows["grid_update"]["launches"] = update_launches
    say(f"incremental path: {update_launches} grid_update launches, every "
        "state bitwise equal to from scratch at every head, second updates "
        "no-ops")


# the TPU kernel each hand-written kernel replaces (wrapper function)
REPLACES = {
    "qvp_reduce": "src/repro/kernels/qvp_reduce.py:43",
    "zr_accum": "src/repro/kernels/zr_accum.py:44",
    "grid_map": "src/repro/kernels/grid_map.py:58",
    "grid_update": "src/repro/kernels/grid_update.py:59",
}


def run_phases(peak_bw: float, peak_flops: float):
    """Phases 3 to 6; returns the per-kernel rows of the JSON line."""
    t_start = time.perf_counter()

    def elapsed(phase: str) -> None:
        say(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s")

    # 3. kernels against their plain versions
    rows = check_kernels(peak_bw, peak_flops)
    rows.update(check_grid_kernels(peak_bw, peak_flops))
    elapsed("3 (kernel check)")

    # 4. the paths
    work = ROOT / ".chip_smoke"
    work.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="archive-", dir=work)
    try:
        archive, vcp, volumes, sim, site = build_archive(tmp)
        elapsed("4 (archive)")
        drive_main_path(archive, vcp, volumes, rows)
        del volumes
        drive_grid_path(archive, rows)
        elapsed("4 (QVP, QPE and grid paths)")
        # 5. end-to-end times
        for workers in (1, os.cpu_count() or 1):
            time_products(archive, workers)
            time_grid_products(archive, workers)
        time_store_layers(archive)
        elapsed("5 (times)")
        # 6. the incremental path, which appends to the archive
        drive_incremental_path(archive, vcp, sim, site, rows)
        elapsed("6 (incremental path)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    say("library_ms: null for every kernel: no single PyTorch call computes "
        "a quality-masked azimuthal mean, a Z-R integral, a masked weighted "
        "mean over a gather map or a pos-mapped set/add/max combine")
    return [{
        "name": kname, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
        "replaces": REPLACES[kname], "launches": row["launches"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
    } for kname, row in rows.items()]


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
    peak_bw, peak_flops = card_peaks(name)
    say(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} device(s))")

    # 2. build
    t = time.perf_counter()
    logs = _cuda.build()
    say(f"build: {len(logs)} kernel(s) compiled in parallel in "
        f"{time.perf_counter() - t:.1f} s into {_cuda.BUILD_DIR}")
    for kname, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                say(f"build {kname}: {line.strip()}")

    kernels = run_phases(peak_bw, peak_flops)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
