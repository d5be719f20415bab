#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines:

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) into the package's
   ``kernels/build/`` directory;
3. kernel check: each kernel against its plain PyTorch version on the
   card, at the main-path shapes and at ragged ones, with the tolerances
   of the reference package's kernel tests, and twice for bitwise
   stability;
4. main path: a versioned archive at VCP-212's full width (720 azimuths x
   1192 gates, cut only in depth), then QVP and QPE through
   ``repro_torch.radar.products.compute_product`` on ``device="cuda"``
   with each kernel's launch counter read around its product, each result
   held against the plain version on the card and the numpy file-based
   baseline;
5. times: each kernel (CUDA events, median) beside its plain version and
   its bound, and each product end to end, split into store read and
   decode, host-to-device copy, kernel, and device-to-host copy.

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
ELEVATIONS = (0.5, 19.5)          # sweep 0 feeds QPE, sweep 1 (top cut) QVP
MOMENTS = ("DBZH", "RHOHV")
T0 = 1305849600.0                 # 2011-05-20, the paper's KVNX case
SEED = 0

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

    f = torch.randn(shape, generator=gen, device="cuda") * 12.0 + 20.0
    f[torch.rand(shape, generator=gen, device="cuda") < nan_frac] = float("nan")
    return f


def check_kernels(peak_bw: float, peak_flops: float):
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_shape = (N_SCANS, 720, 1192)
    rows = {}

    # qvp_reduce ------------------------------------------------------------
    qvp_cases = [main_shape, (5, 37, 77), (3, 720, 1193), (1, 9, 1)]
    for shape in qvp_cases:
        field = radar_field(shape, gen)
        quality = torch.rand(shape, generator=gen, device="cuda") * 0.5 + 0.5
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
    field = torch.full((2, 720, 33), float("nan"), device="cuda")
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
        dt_s = torch.rand(shape[0], generator=gen, device="cuda") * 200 + 200
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
    known = ops.zr_accum(torch.full((1, 1, 1), 40.0, device="cuda"),
                         torch.tensor([3600.0], device="cuda"), mode="kernel")
    expected = (1e4 / 200.0) ** (1 / 1.6)
    if abs(float(known) - expected) > 1e-4 * expected:
        raise AssertionError(f"zr_accum: 40 dBZ for 1 h gave {float(known)}, "
                             f"expected {expected}")
    below = ops.zr_accum(torch.full((3, 4, 8), -5.0, device="cuda"),
                         torch.full((3,), 300.0, device="cuda"), mode="kernel")
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


# -- phase 4: the archive and the main path -----------------------------------

def build_archive(path: str):
    from repro_torch.core import RadarArchive, fm301
    from repro_torch.etl import StormSimulator
    from repro_torch.store import Repository

    full = fm301.VCPS["VCP-212"]
    vcp = fm301.VCPDef(full.vcp_id, ELEVATIONS, full.n_azimuth,
                       full.n_gates, full.gate_m, full.interval_s)
    say(f"archive: VCP-212 at full width: {vcp.n_azimuth} azimuths x "
        f"{vcp.n_gates} gates at {vcp.gate_m:.0f} m, {vcp.interval_s:.0f} s "
        f"between volumes, t0 = {T0:.0f}")
    say(f"cut time: {N_SCANS} scans = {N_SCANS // 16} time chunks of 16, "
        f"{N_SCANS * vcp.interval_s / 3600:.1f} h")
    say(f"cut sweeps: {len(ELEVATIONS)} of {full.n_sweeps}, elevations "
        f"{ELEVATIONS} (sweep 0 for QPE, sweep 1 for QVP)")
    say(f"cut moments: {', '.join(MOMENTS)} of {len(fm301.MOMENTS)}")
    sim = StormSimulator(seed=SEED)
    site = fm301.SITES["KVNX"]

    def volume(i):
        vol = sim.volume(site, vcp, T0 + i * vcp.interval_s)
        for sw in vol["sweeps"]:
            sw["moments"] = {m: sw["moments"][m] for m in MOMENTS}
        return vol

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
    return archive, vcp, volumes


def drive_main_path(archive, vcp, volumes, rows):
    import torch
    from repro_torch.kernels import qvp_reduce, zr_accum
    from repro_torch.radar import (ProductRequest, compute_product,
                                   qpe_from_volumes, qvp_from_volumes)

    qvp_req = ProductRequest(kind="qvp", vcp="VCP-212", sweep=1)
    qpe_req = ProductRequest(kind="qpe", vcp="VCP-212", sweep=0)
    counters = {"qvp_reduce": qvp_reduce, "zr_accum": zr_accum}
    results = {}
    for product, req, kernel in (("qvp", qvp_req, "qvp_reduce"),
                                 ("qpe", qpe_req, "zr_accum")):
        with archive.session() as session:
            for mod in counters.values():
                mod.launches = 0
            results[product] = compute_product(session, req, device="cuda")
            torch.cuda.synchronize()
            launched = {k: m.launches for k, m in counters.items()}
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
                                  device="cuda")
        qpe_ref = compute_product(session, qpe_req.with_options(mode="ref"),
                                  device="cuda")
    e1 = compare("QVP vs plain on the card", torch.from_numpy(qvp.profile),
                 torch.from_numpy(qvp_ref.profile), **QVP_TOL)
    e2 = compare("QPE vs plain on the card", torch.from_numpy(qpe.accum_mm),
                 torch.from_numpy(qpe_ref.accum_mm), **QPE_TOL)
    base_qvp = qvp_from_volumes(volumes, sweep=1)
    base_qpe = qpe_from_volumes(volumes, sweep=0)
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


# -- phase 5: end-to-end split ------------------------------------------------

def time_products(archive, read_workers: int, reps: int = 3):
    """Median over ``reps`` fresh sessions: end-to-end compute_product, and
    the same work split into its layers."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.radar import ProductRequest, compute_product
    from repro_torch.radar.qpe import _dt_weights, read_qpe_inputs
    from repro_torch.radar.qvp import read_qvp_inputs

    reqs = {"qvp": ProductRequest(kind="qvp", vcp="VCP-212", sweep=1),
            "qpe": ProductRequest(kind="qpe", vcp="VCP-212", sweep=0)}
    out = {}
    for product, req in reqs.items():
        split = {k: [] for k in ("e2e_ms", "read_ms", "h2d_ms", "kernel_ms",
                                 "d2h_ms")}
        for _ in range(reps):
            with archive.session(read_workers=read_workers) as session:
                torch.cuda.synchronize()
                t = time.perf_counter()
                compute_product(session, req, device="cuda")
                torch.cuda.synchronize()
                split["e2e_ms"].append((time.perf_counter() - t) * 1e3)
            with archive.session(read_workers=read_workers) as session:
                t0 = time.perf_counter()
                if product == "qvp":
                    inp = read_qvp_inputs(session, vcp="VCP-212", sweep=1)
                    host = (inp.field, inp.quality)
                else:
                    inp = read_qpe_inputs(session, vcp="VCP-212", sweep=0)
                    host = (inp.dbz, _dt_weights(inp.times))
                t1 = time.perf_counter()
                fetches = session.cache_stats()["chunk_fetches"]
                dev = [torch.from_numpy(h).to("cuda") for h in host]
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

    arrays = {"qvp": ["VCP-212/sweep_1/DBZH", "VCP-212/sweep_1/RHOHV"],
              "qpe": ["VCP-212/sweep_0/DBZH"]}
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

    # 3. kernels against their plain versions
    rows = check_kernels(peak_bw, peak_flops)

    # 4. the main path
    work = ROOT / ".chip_smoke"
    work.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="archive-", dir=work)
    try:
        archive, vcp, volumes = build_archive(tmp)
        drive_main_path(archive, vcp, volumes, rows)
        del volumes
        # 5. end-to-end times
        for workers in (1, os.cpu_count() or 1):
            time_products(archive, workers)
        time_store_layers(archive)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for kname, src_line in (("qvp_reduce", "src/repro/kernels/qvp_reduce.py:43"),
                            ("zr_accum", "src/repro/kernels/zr_accum.py:44")):
        row = rows[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": src_line, "launches": row["launches"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
