#!/usr/bin/env python3
"""Calibrate ``chip_smoke.py``'s bf16 logits gate for the Mamba-2 scan on the CPU.

    python3 tools/ssm_logits_gate.py [--layers 26] [--d-model 512] [--tokens 1024]

zamba2-1.2b cut to ``--layers`` layers of ``--d-model`` (P = N = 64, 64-wide
attention heads, a shared block every 6 layers as at full size), weights
from ``init_params(seed=0)``, bf16 compute, 3 prompts of ``--tokens``
random tokens from seed 0.  The prefill's last-position logits with the
Mamba-2 scan on its plain version (the sequential recurrence) are the
reference; each variant swaps the scan and prints each request's L2
error over its L2 norm, worst row (``chip_smoke.row_rel_err``):

* ``chunks``: ``ref.mamba2_scan_chunks``, the chunked form with the
  tensor-core kernel's roundings (how far two right scans' logits lie
  apart, the floor of the gate);
* ``carry``: the carried state dropped from the last chunk's y, and
  ``mask``: M formed above the diagonal (``chip_smoke.ssm_fault``);
* ``zero``: every y zeroed (all the scan moves the logits).

Runs on the CPU and prints one JSON line; keep the cut small (a 26-layer,
512-wide cut over 1024 tokens takes minutes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=26)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--tokens", type=int, default=1024)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_any_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.kernels import ref
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.serve import prefill

    full = get_any_config(cs.ZAMBA_ARCH)
    cfg = full.reduced(n_layers=args.layers, d_model=args.d_model,
                       n_heads=8, n_kv_heads=8, d_head=64, d_ff=2048,
                       vocab_size=4096)
    cfg = dataclasses.replace(cfg, ssm=full.ssm)
    pcfg = ParallelConfig(compute_dtype="bfloat16",
                          kv_cache_dtype="bfloat16", remat="none")
    params = M.compute_params(M.init_params(cfg, 0, device="cpu"),
                              pcfg.compute_dtype)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        2, 256, size=(3, args.tokens)).astype(np.int32))

    def zero(*scan_args):
        y, h = cs.plain_scan(*scan_args)
        return torch.zeros_like(y), h

    variants = {
        "plain": cs.plain_scan,
        "chunks": lambda x, dt, A, Bm, Cm, h0: ref.mamba2_scan_chunks(
            x, dt, A, Bm, Cm, h0=h0),
        "carry": lambda *a: cs.ssm_fault(*a, "carry"),
        "mask": lambda *a: cs.ssm_fault(*a, "mask"),
        "zero": zero,
    }
    logits = {}
    saved = ssm.kops
    try:
        for name, fn in variants.items():
            ssm.kops = cs.ScanShim(fn)
            caches = M.init_caches(cfg, pcfg, prompt.shape[0],
                                   args.tokens + 8, device="cpu")
            logits[name] = prefill(cfg, pcfg, params, caches,
                                   prompt)[0].float()
    finally:
        ssm.kops = saved
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "tokens": args.tokens}
    for name in variants:
        if name != "plain":
            out[name] = cs.row_rel_err(logits[name], logits["plain"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
