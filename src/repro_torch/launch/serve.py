"""Serving from the command line: batched generation on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch radar-lm-100m --requests 8 --prompt-len 64 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --reduced --device cpu

The port of the reference package's ``launch/serve.py``: random
parameters (``init_params(cfg, 0)``, made in the compute dtype), or with
``--ckpt`` the parameters of
the newest checkpoint in that repository (``launch.train --ckpt``), and
random prompts, as there.  ``--device`` defaults to ``cuda``; ``--device
cpu`` runs the plain PyTorch versions of the kernels.  Off the CPU the
model computes in bfloat16 with a bfloat16 KV cache, on the CPU in
float32.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_any_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.models import model as M
from repro_torch.models.convert import from_reference
from repro_torch.radar._device import resolve_device
from repro_torch.serve import Engine, Request
from repro_torch.store import Repository
from repro_torch.train import (AdamWConfig, CheckpointManager,
                               train_state_specs)


def load_checkpoint(cfg, path: str, device) -> M.LMParams:
    """The parameters of the newest checkpoint in the repository at
    ``path`` (``launch.train --ckpt``, or the reference's), on
    ``device``."""
    mgr = CheckpointManager(Repository.open(path))
    step = mgr.latest_step()
    if step is None:
        raise SystemExit(f"--ckpt {path}: the repository holds no "
                         "checkpoint")
    specs = train_state_specs(cfg, AdamWConfig(), ParallelConfig()).params
    tree = mgr.restore(specs, step=step, device=device, subtree="params")
    print(f"parameters of checkpoint step {step}")
    return from_reference(cfg, tree, device=device)


def make_requests(cfg, n: int, prompt_len: int, new_tokens: int,
                  temperature: float = 0.0):
    """The command line's requests: ``n`` prompts from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [
        Request(
            prompt=rng.integers(2, cfg.vocab_size,
                                size=(prompt_len,)).astype(np.int32),
            max_new_tokens=new_tokens,
            temperature=temperature,
        )
        for _ in range(n)
    ]


def main(argv=None):
    """CLI entry point; see the module docstring.  Returns the
    completions."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="radar-lm-100m")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="bound the engine batch size; requests are "
                         "planned into FIFO batches (default: one batch)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_any_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = "float32" if device.type == "cpu" else "bfloat16"
    pcfg = ParallelConfig(compute_dtype=dtype, kv_cache_dtype=dtype,
                          remat="none")
    # random parameters in the compute dtype: deepseek-v2-lite-16b's 15.7 B
    # in float32 and their bfloat16 copy would not fit an 80 GB card
    params = (load_checkpoint(cfg, args.ckpt, device) if args.ckpt
              else M.init_params(cfg, 0, device=device,
                                 dtype=getattr(torch, dtype)))

    eng = Engine(cfg, pcfg, params, max_len=args.max_len, device=device)
    reqs = make_requests(cfg, args.requests, args.prompt_len,
                         args.new_tokens, args.temperature)
    t0 = time.time()
    outs = eng.generate(reqs, seed=1, max_batch=args.max_batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_new = sum(int(np.asarray(o.tokens).shape[-1]) for o in outs)
    print(f"{len(outs)} completions, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s) on {device}")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {np.asarray(o.tokens).ravel()[:16]} ... "
              f"[{o.finished}]")
    return outs


if __name__ == "__main__":
    main()
