"""Model top level: init, forward, loss, KV caches and the decode step.

The port of the reference package's ``models/model.py``, for every
architecture of ``repro_torch.configs``.  The parameters are an
:class:`LMParams` module (token embedding and head, one ``nn.ModuleDict``
per layer, the final norm, zamba2's ``shared`` block) on an explicit
device, with the reference's leaf names and ``(d_in, d_out)`` layouts;
``params["embed"]`` reads like the reference's pytree.  Each pass casts
them as the reference does (:func:`compute_params`); a caller that serves
many steps (``serve.Engine``) hands the cast tree back in, so the cast is
paid once and not per step.

Batch formats by family:
  * LM: ``{"tokens": (B, S) int, "targets": (B, S) int}``
  * vlm (qwen2-vl): ``{"embeds": (B, S, D), "positions3": (B, 3, S)}``
  * audio (musicgen): ``{"codes": (B, K, S) int}``
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig, ParallelConfig
from ..radar._device import DeviceLike, resolve_device
from .layers import (apply_norm, embed_tokens, init_embeddings, init_norm,
                     unembed)
from . import attention, ssm, xlstm
from .transformer import (LayerSpec, SharedBlock, apply_unit, init_layer,
                          init_shared_block, layer_groups)

Params = Any
Caches = List[List[Dict[str, torch.Tensor]]]


class LMParams(nn.Module):
    """The parameter tree: ``embed`` (``tokens``, ``head``), ``groups``
    (per layer group, per repeat, ``{"layer_i": {mixer, norm1, ffn,
    norm2}}``), ``final_norm`` and, for zamba2, ``shared``.  Indexing by
    name reads an attribute, so
    ``params["groups"][g][r]["layer_0"]["mixer"]["wq"]`` is the
    reference's ``params["groups"][g]["layer_0"]["mixer"]["wq"][r]``."""

    def __init__(self, embed: nn.ParameterDict, groups: nn.ModuleList,
                 final_norm: nn.ParameterDict,
                 shared: Optional[SharedBlock] = None):
        super().__init__()
        self.embed = embed
        self.groups = groups
        self.final_norm = final_norm
        self.shared = shared

    def _names(self):
        names = ["embed", "groups", "final_norm"]
        return names + ["shared"] if self.shared is not None else names

    def __getitem__(self, key: str):
        if key not in self._names():
            raise KeyError(key)
        return getattr(self, key)

    def items(self):
        return [(k, self[k]) for k in self._names()]


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
    specs = layer_groups(cfg)
    for reps, unit in specs:
        groups.append(nn.ModuleList(
            nn.ModuleDict({f"layer_{i}": init_layer(cfg, spec, gen, dtype,
                                                    dev)
                           for i, spec in enumerate(unit)
                           if spec.mixer != "shared_attn"})
            for _ in range(reps)))
    shared = None
    if any(s.mixer == "shared_attn" for _r, u in specs for s in u):
        shared = init_shared_block(cfg, gen, dtype, dev)
    return LMParams(embed, groups, init_norm(cfg, cfg.d_model, dtype, dev),
                    shared)


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count for ``cfg`` (shapes only, no allocation)."""
    return sum(p.numel() for p in
               init_params(cfg, device="meta").parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token uses: for a mixture of experts, the top-k routed
    and the shared experts of each MoE layer only."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    expert_p = 3 * cfg.d_model * m.d_ff_expert
    n_moe_layers = (cfg.n_layers - m.first_dense) // m.interleave
    return total - n_moe_layers * (m.n_experts - m.top_k) * expert_p


def compute_params(params: Params, compute_dtype, *,
                   detach: bool = True) -> Dict[str, Any]:
    """The reference's cast rule as a plain nested dict of tensors.

    The reference casts float32 leaves with ``ndim > 1`` to
    ``compute_dtype``, on its tree in which every leaf under ``groups`` is
    stacked over the group's repeats: there a 1-D leaf (a norm scale, a
    bias, ``A_log``, ``dt_bias``, ``D``) is 2-D and is cast too.  So every
    float32 leaf under ``groups`` goes to ``compute_dtype``; outside them
    (``embed``, ``final_norm``, ``shared``) the ``ndim > 1`` rule holds as
    written.  Idempotent, so its result can be passed wherever ``params``
    is.  ``detach=False`` keeps the leaves in the autograd graph (the
    training step's path, :func:`train_loss`)."""
    dtype = _dtype(compute_dtype)

    def cast(node, stacked: bool):
        if isinstance(node, torch.Tensor):
            if node.dtype == torch.float32 and (stacked or node.ndim > 1):
                node = node.to(dtype)
            return node.detach() if detach else node
        if isinstance(node, (list, tuple, nn.ModuleList)):
            return [cast(n, stacked) for n in node]
        return {k: cast(v, stacked) for k, v in node.items()}

    return {k: cast(v, k == "groups") for k, v in params.items()}


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


def _forward(cfg: ModelConfig, pcfg: ParallelConfig, params: Params,
             batch: Dict, attn_impl: str, detach: bool, **flags
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    compute_dtype = _dtype(pcfg.compute_dtype)
    cparams = compute_params(params, compute_dtype, detach=detach)
    x, positions = _embed_batch(cfg, cparams, batch, compute_dtype)
    emb0 = x
    shared = cparams.get("shared")
    aux_total: Dict[str, torch.Tensor] = {}
    for gi, (reps, unit) in enumerate(layer_groups(cfg)):
        for r in range(reps):
            x, aux, _ = apply_unit(cfg, unit, cparams["groups"][gi][r],
                                   shared, x, positions, attn_impl=attn_impl,
                                   emb0=emb0, **flags)
            for k, v in aux.items():
                aux_total[k] = aux_total.get(k, 0.0) + v
    x = apply_norm(cfg, cparams["final_norm"], x)
    return unembed(cfg, cparams["embed"], x), aux_total


def _loss(cfg: ModelConfig, pcfg: ParallelConfig, params: Params,
          batch: Dict, attn_impl: str, detach: bool, **flags
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = _forward(cfg, pcfg, params, batch, attn_impl, detach,
                           **flags)
    targets = _as_tensor(batch["targets"], logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    gathered = torch.gather(logits, -1, targets[..., None])[..., 0]
    loss = torch.mean(lse - gathered)
    metrics = {"loss": loss, **aux}
    total = loss + sum(v for k, v in aux.items() if k.startswith("moe_"))
    return total, metrics


@torch.inference_mode()
def forward(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    params: Params,
    batch: Dict,
    *,
    attn_impl: str = "blocked",
    slstm_cost_proxy: bool = False,
    moe_dropless: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cache-less forward -> (float32 logits, aux).  ``moe_dropless``
    sends MoE layers to the dense dispatch (else the sorted capacity one);
    ``slstm_cost_proxy`` sends sLSTM layers to the dry-run's dense stand-in
    for the recurrence (never for real outputs)."""
    return _forward(cfg, pcfg, params, batch, attn_impl, True,
                    slstm_cost_proxy=slstm_cost_proxy,
                    moe_dropless=moe_dropless)


@torch.inference_mode()
def loss_fn(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    params: Params,
    batch: Dict,
    *,
    attn_impl: str = "blocked",
    slstm_cost_proxy: bool = False,
    moe_dropless: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over one batch (forward only), plus
    the MoE aux losses (``moe_*``) in the total; the flags as
    :func:`forward`'s."""
    return _loss(cfg, pcfg, params, batch, attn_impl, True,
                 slstm_cost_proxy=slstm_cost_proxy,
                 moe_dropless=moe_dropless)


def train_loss(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    params: Params,
    batch: Dict,
    *,
    attn_impl: str = "blocked",
    slstm_cost_proxy: bool = False,
    moe_dropless: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`loss_fn` inside the autograd graph: ``params`` (an
    :class:`LMParams` or the same tree of plain tensors, one layer per
    repeat) may hold leaves that require gradients, and the loss carries
    them.  The reference's training step differentiates its ``loss_fn``
    on the ``"blocked"`` core; so does the port's
    (:func:`repro_torch.train.make_train_step`)."""
    return _loss(cfg, pcfg, params, batch, attn_impl, False,
                 slstm_cost_proxy=slstm_cost_proxy,
                 moe_dropless=moe_dropless)


# ---------------------------------------------------------------------------
# serving: cache init / decode step
# ---------------------------------------------------------------------------

def _init_one_cache(cfg: ModelConfig, spec: LayerSpec, reps: int, batch: int,
                    max_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    if spec.mixer in ("attn", "shared_attn"):
        one = attention.init_kv_cache(cfg, batch, max_len, dtype, "meta")
    elif spec.mixer == "mla":
        one = attention.init_mla_cache(cfg, batch, max_len, dtype, "meta")
    elif spec.mixer == "mamba2":
        one = ssm.init_mamba2_state(cfg, batch, "meta")
    elif spec.mixer == "mlstm":
        one = xlstm.init_mlstm_state(cfg, batch, "meta")
    elif spec.mixer == "slstm":
        one = xlstm.init_slstm_state(cfg, batch, "meta")
    else:
        raise ValueError(spec.mixer)
    return {k: torch.zeros((reps, *v.shape), dtype=v.dtype, device=device)
            for k, v in one.items()}


def init_caches(cfg: ModelConfig, pcfg: ParallelConfig, batch: int,
                max_len: int, *, device: DeviceLike = None) -> Caches:
    """Zeroed caches in the reference's layout: ``caches[group][unit_pos]``
    holds, with a leading ``reps`` axis, ``{"k", "v"}`` of shape
    ``(reps, B, Hkv, max_len, head_dim)`` in ``pcfg.kv_cache_dtype`` for an
    attention layer (zamba2's shared block too), ``{"latent": (reps, B,
    max_len, kv_lora), "k_rope": (reps, B, max_len, rope)}`` in that dtype
    for an MLA layer, and in float32 ``{"ssm": (reps, B, H, P, N), "conv":
    (reps, B, W - 1, d_inner + 2N)}`` for a Mamba-2 layer, ``{"C": (reps,
    B, H, dh, dh + 1), "conv": (reps, B, W - 1, d_inner)}`` for an mLSTM
    layer and ``{"c", "n", "h"}`` (reps, B, H, dh) for an sLSTM layer.
    Each step writes into them in place."""
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
    through the stack, writing their keys and values (an MLA layer's
    latents) into ``caches`` at ``cache_index``, and each recurrent layer's
    new state (Mamba-2, mLSTM, sLSTM) over its old one, in place ->
    (float32 logits (B, S, V), caches).  MoE layers dispatch densely
    (exact, no drops) for S <= 64, as the reference serves a decode step,
    and by sorted capacity dispatch for a longer prefill."""
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
    emb0 = x
    shared = cparams.get("shared")
    dropless = S <= 64
    for gi, (reps, unit) in enumerate(layer_groups(cfg)):
        for r in range(reps):
            layer_caches = [{k: c[r] for k, c in caches[gi][i].items()}
                            for i in range(len(unit))]
            x, _aux, _ = apply_unit(cfg, unit, cparams["groups"][gi][r],
                                    shared, x, positions, caches=layer_caches,
                                    cache_index=start, attn_impl=attn_impl,
                                    emb0=emb0, moe_dropless=dropless)
    x = apply_norm(cfg, cparams["final_norm"], x)
    return unembed(cfg, cparams["embed"], x), caches
