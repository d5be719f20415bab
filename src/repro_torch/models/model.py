"""Model top level: init, forward, loss, KV caches and the decode step.

The port of the reference package's ``models/model.py`` for the
architectures whose layers are ported (the ``attn`` mixer with the dense
FFN).  The parameters are an :class:`LMParams` module (token embedding
and head, one ``nn.ModuleDict`` per layer, the final norm) on an explicit
device, with the reference's leaf names and ``(d_in, d_out)`` layouts;
``params["embed"]`` reads like the reference's pytree.  Each pass casts
them as the reference does: float32 leaves with ``ndim > 1`` go to
``compute_dtype``, norm scales stay float32.  :func:`compute_params` does
that cast once, and a caller that serves many steps (``serve.Engine``)
hands its result back in, so the cast is paid once and not per step.

Batch formats by family:
  * LM: ``{"tokens": (B, S) int, "targets": (B, S) int}``
  * vlm (qwen2-vl): ``{"embeds": (B, S, D), "positions3": (B, 3, S)}``
  * audio (musicgen): ``{"codes": (B, K, S) int}``
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig, ParallelConfig
from ..radar._device import DeviceLike, resolve_device
from .layers import (apply_norm, embed_tokens, init_embeddings, init_norm,
                     unembed)
from .transformer import (LayerSpec, apply_unit, init_layer, layer_groups,
                          not_ported)

Params = Any
Caches = List[List[Dict[str, torch.Tensor]]]


class LMParams(nn.Module):
    """The parameter tree: ``embed`` (``tokens``, ``head``), ``groups``
    (per layer group, per repeat, ``{"layer_i": {mixer, norm1, ffn,
    norm2}}``) and ``final_norm``.  Indexing by name reads an attribute,
    so ``params["groups"][g][r]["layer_0"]["mixer"]["wq"]`` is the
    reference's ``params["groups"][g]["layer_0"]["mixer"]["wq"][r]``."""

    def __init__(self, embed: nn.ParameterDict, groups: nn.ModuleList,
                 final_norm: nn.ParameterDict):
        super().__init__()
        self.embed = embed
        self.groups = groups
        self.final_norm = final_norm

    def __getitem__(self, key: str):
        if key not in ("embed", "groups", "final_norm"):
            raise KeyError(key)
        return getattr(self, key)

    def items(self):
        return [(k, self[k]) for k in ("embed", "groups", "final_norm")]


# ---------------------------------------------------------------------------
# init & bookkeeping
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> LMParams:
    """Random parameters for ``cfg`` from a ``torch.Generator`` seeded with
    ``seed``: the reference's distributions, not its numbers.  ``device``
    ``None`` means ``"cuda"``; ``"meta"`` allocates nothing."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    embed = init_embeddings(cfg, gen, dtype, dev)
    groups = nn.ModuleList()
    for reps, unit in layer_groups(cfg):
        groups.append(nn.ModuleList(
            nn.ModuleDict({f"layer_{i}": init_layer(cfg, spec, gen, dtype,
                                                    dev)
                           for i, spec in enumerate(unit)})
            for _ in range(reps)))
    return LMParams(embed, groups, init_norm(cfg, cfg.d_model, dtype, dev))


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count for ``cfg`` (shapes only, no allocation)."""
    return sum(p.numel() for p in
               init_params(cfg, device="meta").parameters())


def compute_params(params: Params, compute_dtype) -> Dict[str, Any]:
    """The reference's cast rule as a plain nested dict of tensors:
    float32 leaves with ``ndim > 1`` in ``compute_dtype``, the rest as they
    are.  Idempotent, so its result can be passed wherever ``params`` is."""
    dtype = _dtype(compute_dtype)

    def cast(node):
        if isinstance(node, torch.Tensor):
            if node.dtype == torch.float32 and node.ndim > 1:
                return node.detach().to(dtype)
            return node.detach()
        if isinstance(node, (list, tuple, nn.ModuleList)):
            return [cast(n) for n in node]
        return {k: cast(v) for k, v in node.items()}

    return cast(params)


def _dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def _device(cparams) -> torch.device:
    return cparams["final_norm"]["scale"].device


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _embed_batch(cfg: ModelConfig, cparams, batch: Dict,
                 compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x (B, S, D), positions)."""
    dev = _device(cparams)
    if "embeds" in batch:                    # vlm stub frontend
        x = _as_tensor(batch["embeds"], dev)
        positions = _as_tensor(batch["positions3"] if cfg.mrope
                               else batch["positions"], dev)
    else:
        key = "codes" if "codes" in batch else "tokens"
        toks = _as_tensor(batch[key], dev).long()
        x = embed_tokens(cfg, cparams["embed"], toks)
        B, S = toks.shape[0], toks.shape[-1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev).expand(B, S)
    return x.to(compute_dtype), positions


@torch.inference_mode()
def forward(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    params: Params,
    batch: Dict,
    *,
    attn_impl: str = "blocked",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cache-less forward -> (float32 logits, aux)."""
    compute_dtype = _dtype(pcfg.compute_dtype)
    cparams = compute_params(params, compute_dtype)
    x, positions = _embed_batch(cfg, cparams, batch, compute_dtype)
    aux_total: Dict[str, torch.Tensor] = {}
    for gi, (reps, unit) in enumerate(layer_groups(cfg)):
        for r in range(reps):
            x, aux, _ = apply_unit(cfg, unit, cparams["groups"][gi][r], x,
                                   positions, attn_impl=attn_impl)
            for k, v in aux.items():
                aux_total[k] = aux_total.get(k, 0.0) + v
    x = apply_norm(cfg, cparams["final_norm"], x)
    return unembed(cfg, cparams["embed"], x), aux_total


@torch.inference_mode()
def loss_fn(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    params: Params,
    batch: Dict,
    *,
    attn_impl: str = "blocked",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over one batch (forward only)."""
    logits, aux = forward(cfg, pcfg, params, batch, attn_impl=attn_impl)
    targets = _as_tensor(batch["targets"], logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    gathered = torch.gather(logits, -1, targets[..., None])[..., 0]
    loss = torch.mean(lse - gathered)
    metrics = {"loss": loss, **aux}
    total = loss + sum(v for k, v in aux.items() if k.startswith("moe_"))
    return total, metrics


# ---------------------------------------------------------------------------
# serving: cache init / decode step
# ---------------------------------------------------------------------------

def _init_one_cache(cfg: ModelConfig, spec: LayerSpec, reps: int, batch: int,
                    max_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    if spec.mixer != "attn":
        raise not_ported(spec.mixer)
    shape = (reps, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k in ("k", "v")}


def init_caches(cfg: ModelConfig, pcfg: ParallelConfig, batch: int,
                max_len: int, *, device: DeviceLike = None) -> Caches:
    """Zeroed caches in the reference's layout: ``caches[group][unit_pos]``
    holds ``{"k", "v"}`` of shape ``(reps, B, Hkv, max_len, head_dim)`` in
    ``pcfg.kv_cache_dtype``.  Each step writes into them in place."""
    dev = resolve_device(device)
    dtype = _dtype(pcfg.kv_cache_dtype)
    return [[_init_one_cache(cfg, spec, reps, batch, max_len, dtype, dev)
             for spec in unit]
            for reps, unit in layer_groups(cfg)]


@torch.inference_mode()
def decode_step(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    params: Params,
    caches: Caches,
    tokens_or_embeds: Union[torch.Tensor, np.ndarray],  # (B, S) | (B, S, D)
    cache_index: int,                # tokens already in the cache
    *,
    attn_impl: str = "blocked",
) -> Tuple[torch.Tensor, Caches]:
    """Run S new tokens (S = 1 decode, S > 1 prefill or a prefill chunk)
    through the stack, writing their keys and values into ``caches`` at
    ``cache_index`` in place -> (float32 logits (B, S, V), caches)."""
    compute_dtype = _dtype(pcfg.compute_dtype)
    cparams = compute_params(params, compute_dtype)
    dev = _device(cparams)
    x = _as_tensor(tokens_or_embeds, dev)
    if not x.is_floating_point():
        x = embed_tokens(cfg, cparams["embed"], x.long())
        B, S = tokens_or_embeds.shape[0], tokens_or_embeds.shape[-1]
    else:
        B, S = x.shape[0], x.shape[1]
    start = int(cache_index)
    pos = torch.arange(start, start + S, dtype=torch.int32,
                       device=dev).expand(B, S)
    positions = pos[:, None, :].expand(B, 3, S) if cfg.mrope else pos
    x = x.to(compute_dtype)
    for gi, (reps, unit) in enumerate(layer_groups(cfg)):
        for r in range(reps):
            layer_caches = [{k: c[r] for k, c in caches[gi][i].items()}
                            for i in range(len(unit))]
            x, _aux, _ = apply_unit(cfg, unit, cparams["groups"][gi][r], x,
                                    positions, caches=layer_caches,
                                    cache_index=start, attn_impl=attn_impl)
    x = apply_norm(cfg, cparams["final_norm"], x)
    return unembed(cfg, cparams["embed"], x), caches
