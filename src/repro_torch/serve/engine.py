"""Serving engine: prefill + decode over explicit KV caches, batched requests.

The port of the reference package's ``serve/engine.py``.  Two layers:

* **Steps** — ``prefill`` runs the prompt through the stack, writing the KV
  caches (in ``chunk``-token slices when asked); ``decode`` advances one
  token.  Both are thin views over ``model.decode_step``.
* **Engine** — aligned static batches: prompts left-padded to a shared
  length, one prefill, lockstep decode, per-slot stop handling, FIFO batch
  plans from :func:`repro_torch.serve.scheduling.plan_batches`.

PyTorch runs eagerly, so ``cache_index`` is a Python int and every
attention call, prefill and decode, goes through the hand-written
flash-attention kernel under ``attn_impl="kernel"`` (the default here;
the reference's steps default to its non-kernel ``"blocked"`` core): GQA
layers, and DeepSeek's MLA layers over the latent cache at the q/k width
(192 at full width); every Mamba-2 call (zamba2) goes through the
``mamba2_scan`` kernel from the cached SSM state.  xLSTM's mLSTM and sLSTM
layers step their float32 states token by token in plain PyTorch, as the
reference does; a MoE FFN dispatches densely at decode and by sorted
capacity dispatch on a prefill longer than 64 tokens.
Temperature sampling draws from a ``torch.Generator`` seeded per batch
with ``seed + batch index``: deterministic, but not the reference's
``jax.random`` numbers.  Greedy decoding is the same function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, ParallelConfig
from ..models import model as M
from ..radar._device import DeviceLike, resolve_device
from .scheduling import plan_batches

Params = Any


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, pcfg: ParallelConfig, params: Params,
            caches: M.Caches, tokens: torch.Tensor,
            *, attn_impl: str = "kernel",
            chunk: Optional[int] = None) -> Tuple[torch.Tensor, M.Caches]:
    """Prompt -> (last-position logits, filled caches).

    ``chunk`` bounds peak activation memory for very long prompts by
    running the prompt through in ``chunk``-token slices (each slice
    attends to all cached earlier slices) — chunked prefill.
    """
    S = tokens.shape[-1]
    if chunk is None or chunk >= S:
        logits, caches = M.decode_step(cfg, pcfg, params, caches, tokens, 0,
                                       attn_impl=attn_impl)
        return _last_pos(logits), caches
    logits = None
    for start in range(0, S, chunk):
        piece = tokens[..., start:start + chunk]
        logits, caches = M.decode_step(cfg, pcfg, params, caches, piece,
                                       start, attn_impl=attn_impl)
    return _last_pos(logits), caches


def decode(cfg: ModelConfig, pcfg: ParallelConfig, params: Params,
           caches: M.Caches, tokens: torch.Tensor, cache_index: int,
           *, attn_impl: str = "kernel") -> Tuple[torch.Tensor, M.Caches]:
    """One new token per sequence -> (vocab logits, updated caches)."""
    logits, caches = M.decode_step(cfg, pcfg, params, caches, tokens,
                                   cache_index, attn_impl=attn_impl)
    return _last_pos(logits), caches


def _last_pos(logits: torch.Tensor) -> torch.Tensor:
    # (B, S, V) -> (B, V);   (B, K, S, V) -> (B, K, V)
    return logits[..., -1, :]


def sample(logits: torch.Tensor, gen: Optional[torch.Generator], *,
           temperature: float = 0.0) -> torch.Tensor:
    """Greedy (first maximum, as ``argmax``) or temperature sampling from
    final-position logits -> int32 ids."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=gen)[:, 0]
    return ids.reshape(probs.shape[:-1]).to(torch.int32)


# ---------------------------------------------------------------------------
# batched engine
# ---------------------------------------------------------------------------

@dataclass
class Request:
    """One generation request."""
    prompt: np.ndarray               # (S,) i32 or (K, S) for audio archs
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None


@dataclass
class Completion:
    """One finished generation."""
    tokens: np.ndarray               # generated ids, (T,) or (K, T)
    prompt_len: int
    finished: str                    # "eos" | "length"


class Engine:
    """Aligned-batch serving engine on one device.

    Pad prompts to a shared length, prefill once, decode in lockstep;
    per-slot EOS masking.  ``device=None`` means ``"cuda"`` and raises
    without a GPU; ``device="cpu"`` runs the plain PyTorch versions of the
    kernels.  ``params`` must already lie on that device.  Their
    compute-dtype copy is made once, here."""

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig, params: Params,
                 *, max_len: int = 4096, attn_impl: str = "kernel",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.pcfg, self.params = cfg, pcfg, params
        self.cparams = M.compute_params(params, pcfg.compute_dtype)
        where = self.cparams["final_norm"]["scale"].device
        if where.type != self.device.type:
            raise ValueError(f"params lie on {where}, the engine runs on "
                             f"{self.device}")
        self.max_len = max_len
        self.attn_impl = attn_impl
        self.decode_steps = 0         # decode calls since construction

    def generate(self, requests: List[Request], seed: int = 0,
                 max_batch: Optional[int] = None) -> List[Completion]:
        """Serve ``requests``, preserving submission order.

        :func:`plan_batches` splits the FIFO request list into aligned
        batches of at most ``max_batch`` slots (``None``: one batch).  Each
        batch seeds its sampler with ``seed`` plus its batch index, so
        results are deterministic in (requests, seed, max_batch).
        """
        if not requests:
            return []
        out: List[Optional[Completion]] = [None] * len(requests)
        for bi, batch in enumerate(plan_batches(len(requests), max_batch)):
            idxs = list(batch)
            comps = self._generate_batch(
                [requests[i] for i in idxs], seed + bi)
            for i, comp in zip(idxs, comps):
                out[i] = comp
        return [c for c in out if c is not None]

    @torch.inference_mode()
    def _generate_batch(self, requests: List[Request],
                        seed: int) -> List[Completion]:
        cfg = self.cfg
        B = len(requests)
        prompts = [np.asarray(r.prompt, np.int32) for r in requests]
        plen = max(p.shape[-1] for p in prompts)
        if cfg.n_codebooks > 1:
            toks = np.zeros((B, cfg.n_codebooks, plen), np.int32)
        else:
            toks = np.zeros((B, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, ..., plen - p.shape[-1]:] = p        # left-pad

        caches = M.init_caches(cfg, self.pcfg, batch=B, max_len=self.max_len,
                               device=self.device)
        logits, caches = prefill(cfg, self.pcfg, self.cparams, caches,
                                 torch.from_numpy(toks).to(self.device),
                                 attn_impl=self.attn_impl)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        max_new = max(r.max_new_tokens for r in requests)
        temp = max(r.temperature for r in requests)
        done = np.zeros(B, bool)
        outs: List[List] = [[] for _ in range(B)]
        finished = ["length"] * B
        idx = plen
        for t in range(max_new):
            next_tok = sample(logits, gen, temperature=temp)  # (B,) | (B,K)
            nt = next_tok.cpu().numpy()
            for i, r in enumerate(requests):
                if done[i] or t >= r.max_new_tokens:
                    done[i] = True
                    continue
                tok_i = nt[i]
                outs[i].append(tok_i)
                if r.eos_id is not None and np.all(tok_i == r.eos_id):
                    done[i] = True
                    finished[i] = "eos"
            if done.all() or idx + 1 >= self.max_len:
                break
            logits, caches = decode(cfg, self.pcfg, self.cparams, caches,
                                    next_tok[..., None], idx,
                                    attn_impl=self.attn_impl)
            self.decode_steps += 1
            idx += 1
        return [
            Completion(np.stack(o, axis=-1) if o else np.zeros((0,), np.int32),
                       prompt_len=plen, finished=f)
            for o, f in zip(outs, finished)
        ]
