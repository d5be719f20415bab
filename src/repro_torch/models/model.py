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

from functools import partial
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig, ParallelConfig
from ..radar._device import DeviceLike, resolve_device
from ..distributed.sharding import (cache_seq_dim, constrain_like_params,
                                    gather_for_compute, is_dtensor,
                                    kv_heads_local, rows_sharded, to_local)
from .layers import (DP, apply_norm, constrain, embed_tokens,
                     init_embeddings, init_norm, unembed,
                     vocab_parallel_terms)
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


def param_specs(cfg: ModelConfig, dtype: torch.dtype = torch.float32):
    """The parameters in the reference's pytree layout (every leaf under
    ``groups`` stacked over its group's repeats) as meta tensors: shapes
    and dtypes, no storage (the dry run's and the sharding rules' input)."""
    from .convert import to_reference
    return to_reference(init_params(cfg, device="meta", dtype=dtype))


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
                   detach: bool = True, gather: bool = True
                   ) -> Dict[str, Any]:
    """The reference's cast rule as a plain nested dict of tensors.

    The reference casts float32 leaves with ``ndim > 1`` to
    ``compute_dtype``, on its tree in which every leaf under ``groups`` is
    stacked over the group's repeats: there a 1-D leaf (a norm scale, a
    bias, ``A_log``, ``dt_bias``, ``D``) is 2-D and is cast too.  So every
    float32 leaf under ``groups`` goes to ``compute_dtype``; outside them
    (``embed``, ``final_norm``, ``shared``) the ``ndim > 1`` rule holds as
    written.  Idempotent, so its result can be passed wherever ``params``
    is.  ``detach=False`` keeps the leaves in the autograd graph (the
    training step's path, :func:`train_loss`).

    DTensor leaves (parameters laid out on a mesh by
    ``distributed.sharding``) are cast shard by shard and, with
    ``gather``, gathered whole onto every rank (the serving path, which
    then computes on plain tensors); without it they stay DTensors for
    :func:`_forward`'s per-layer gather."""
    dtype = _dtype(compute_dtype)

    def cast(node, stacked: bool):
        if isinstance(node, torch.Tensor):
            if node.dtype == torch.float32 and (stacked or node.ndim > 1):
                node = node.to(dtype)
            return node.detach() if detach else node
        if isinstance(node, (list, tuple, nn.ModuleList)):
            return [cast(n, stacked) for n in node]
        return {k: cast(v, stacked) for k, v in node.items()}

    out = {k: cast(v, k == "groups") for k, v in params.items()}
    if gather and any(is_dtensor(t) for t in _tree_leaves(out)):
        out = gather_for_compute(None, out, tp=False, grads=not detach)
    return out


def _tree_leaves(node) -> List[Any]:
    if isinstance(node, dict):
        return [t for v in node.values() for t in _tree_leaves(v)]
    if isinstance(node, (list, tuple)):
        return [t for v in node for t in _tree_leaves(v)]
    return [node]


def _no_grad(fn):
    """``torch.inference_mode`` around a forward-only entry point, or
    ``torch.no_grad`` where the parameters are DTensors (a mesh's: they
    refuse inference mode)."""
    import functools

    @functools.wraps(fn)
    def run(cfg, pcfg, params, *args, **kwargs):
        sharded = is_dtensor(params["final_norm"]["scale"])
        with torch.no_grad() if sharded else torch.inference_mode():
            return fn(cfg, pcfg, params, *args, **kwargs)
    return run


def _dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def _device(cparams) -> torch.device:
    return cparams["final_norm"]["scale"].device


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------

REMAT = ("none", "block", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    output of a matrix product with no batch dims, recompute every other
    op (collectives too, so no gathered weight is kept).  ``torch.einsum``
    lowers a contraction with no batch dims to a ``bmm`` of batch 1, while
    attention's scores and the expert GEMMs are ``bmm``s of batch > 1."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(remat: str, fn, *args):
    """``fn(*args)`` under the reference's rematerialization policy
    ``remat`` (``ParallelConfig.remat``): ``"none"`` keeps every
    activation for the backward pass, ``"block"`` keeps ``fn``'s inputs
    alone and recomputes the rest, ``"dots"`` also keeps the outputs of
    the matrix products with no batch dims (:func:`_dots_policy`).  The
    values are the same under each; memory and recompute are not."""
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r}: one of {REMAT}")
    if remat == "none":
        return fn(*args)
    if remat == "block":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=partial(
        create_selective_checkpoint_contexts, _dots_policy))


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
             batch: Dict, attn_impl: str, detach: bool,
             vocab_parallel: bool = False, **flags
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    compute_dtype = _dtype(pcfg.compute_dtype)
    cparams = compute_params(params, compute_dtype, detach=detach,
                             gather=False)
    # on a mesh: the boundary gathered whole, each layer just before it
    # runs (the reference's per-layer constraint keeps its FSDP gather
    # transient), tensor-parallel blocks kept as this rank's model shard
    grads = not detach
    boundary = {k: gather_for_compute(
        cfg, v, tp=k == "shared" or (k == "embed" and vocab_parallel),
        grads=grads) for k, v in cparams.items() if k != "groups"}
    x, positions = _embed_batch(cfg, boundary, batch, compute_dtype)
    x = constrain(x, DP, None, None)
    emb0 = x
    shared = boundary.get("shared")
    aux_total: Dict[str, torch.Tensor] = {}
    for gi, (reps, unit) in enumerate(layer_groups(cfg)):
        def layer(up, x, unit=unit):
            up = constrain_like_params(cfg, pcfg, up)
            up = gather_for_compute(cfg, up, grads=grads)
            return apply_unit(cfg, unit, up, shared, x, positions,
                              attn_impl=attn_impl, emb0=emb0, **flags)[:2]
        for r in range(reps):
            # the reference's per-layer remat: recompute a layer's
            # activations (and re-gather its weights on a mesh) in the
            # backward pass, keeping what the policy keeps
            x, aux = remat_call(pcfg.remat if grads else "none", layer,
                                cparams["groups"][gi][r], x)
            x = constrain(x, DP, None, None)
            for k, v in aux.items():
                aux_total[k] = aux_total.get(k, 0.0) + v
    cparams = boundary
    x = apply_norm(cfg, cparams["final_norm"], x)
    return unembed(cfg, cparams["embed"], x), aux_total


def _loss(cfg: ModelConfig, pcfg: ParallelConfig, params: Params,
          batch: Dict, attn_impl: str, detach: bool, **flags
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = _forward(cfg, pcfg, params, batch, attn_impl, detach,
                           vocab_parallel=True, **flags)
    targets = _as_tensor(batch["targets"], logits.device).long()
    loss = lm_loss(cfg, logits, targets)
    metrics = {"loss": loss, **aux}
    total = loss + sum(v for k, v in aux.items() if k.startswith("moe_"))
    return total, metrics


def lm_loss(cfg: ModelConfig, logits: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; ``logits`` may be this rank's
    columns of the vocabulary (a vocabulary-parallel unembedding on a
    mesh, :func:`layers.vocab_parallel_terms`)."""
    if logits.shape[-1] < cfg.vocab_size:
        lse, gathered = vocab_parallel_terms(logits, targets, cfg.vocab_size)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gathered = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(lse - gathered)


@_no_grad
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


@_no_grad
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
    replicated_rows: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`loss_fn` inside the autograd graph: ``params`` (an
    :class:`LMParams` or the same tree of plain tensors, one layer per
    repeat) may hold leaves that require gradients, and the loss carries
    them.  The reference's training step differentiates its ``loss_fn``
    on the ``"blocked"`` core; so does the port's
    (:func:`repro_torch.train.make_train_step`).  ``replicated_rows``: on
    a mesh, ``batch`` is the whole batch on every data rank, not this
    rank's rows (``moe.apply_moe``).  Each layer is rematerialized as
    ``pcfg.remat`` says (:func:`remat_call`)."""
    return _loss(cfg, pcfg, params, batch, attn_impl, False,
                 slstm_cost_proxy=slstm_cost_proxy,
                 moe_dropless=moe_dropless,
                 moe_replicated_rows=replicated_rows)


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


@_no_grad
def decode_step(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    params: Params,
    caches: Caches,
    tokens_or_embeds: Union[torch.Tensor, np.ndarray],  # (B, S) | (B, S, D)
    cache_index: int,                # tokens already in the cache
    *,
    attn_impl: str = "blocked",
    last_only: bool = False,
) -> Tuple[torch.Tensor, Caches]:
    """Run S new tokens (S = 1 decode, S > 1 prefill or a prefill chunk)
    through the stack, writing their keys and values (an MLA layer's
    latents) into ``caches`` at ``cache_index``, and each recurrent layer's
    new state (Mamba-2, mLSTM, sLSTM) over its old one, in place ->
    (float32 logits (B, S, V), caches).  MoE layers dispatch densely
    (exact, no drops) for S <= 64, as the reference serves a decode step,
    and by sorted capacity dispatch for a longer prefill.  ``last_only``:
    the last position's logits alone, (B, 1, V), without materializing
    every position's: the serving steps (``serve.engine``) and the dry
    run's prefill and decode cells keep only the last position's, and
    XLA computes no more of the reference's."""
    compute_dtype = _dtype(pcfg.compute_dtype)
    # on a mesh: the parameters gathered layer by layer (MLPs and MoE
    # experts tensor-parallel, and a prefill's GQA, MLA, Mamba-2 and mLSTM
    # heads; a decode step's attention and recurrent heads whole), the
    # caches as laid out by cache_shardings
    cparams = compute_params(params, compute_dtype, gather=False)
    sharded = is_dtensor(cparams["final_norm"]["scale"])
    # a batch whose rows do not divide the data ranks is whole on each
    replicated_rows = False
    if sharded:
        cparams = {k: v if k in ("groups", "shared") else
                   gather_for_compute(cfg, v, tp=False)
                   for k, v in cparams.items()}
        replicated_rows = not rows_sharded(tokens_or_embeds)
        tokens_or_embeds = to_local(tokens_or_embeds)
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
    if sharded and shared is not None:
        shared = gather_for_compute(cfg, shared, attention=S > 1)
    dropless = S <= 64
    for gi, (reps, unit) in enumerate(layer_groups(cfg)):
        for r in range(reps):
            layer_caches = [{k: c[r] for k, c in caches[gi][i].items()}
                            for i in range(len(unit))]
            up = cparams["groups"][gi][r]
            if sharded:
                # a prefill on this rank's heads (a GQA cache moved to
                # them and back, the recurrent blocks all-gathering their
                # new states' heads), a decode step on every head (a
                # flash-decode step's GQA and MLA caches read where they
                # lie, each rank over its own positions)
                up = gather_for_compute(cfg, up, attention=S > 1,
                                        heads=S > 1)
                layer_caches, write_back = _local_caches(
                    layer_caches, attn_impl == "flash_decode" and S == 1,
                    [_gqa_heads_local(cfg, spec, up, shared, i)
                     for i, spec in enumerate(unit)])
            x, _aux, _ = apply_unit(cfg, unit, up, shared, x, positions,
                                    caches=layer_caches, cache_index=start,
                                    attn_impl=attn_impl, emb0=emb0,
                                    moe_dropless=dropless,
                                    moe_replicated_rows=replicated_rows)
            if sharded:
                write_back()
    if last_only:
        x = x[:, -1:]
    x = apply_norm(cfg, cparams["final_norm"], x)
    return unembed(cfg, cparams["embed"], x), caches


def _gqa_heads_local(cfg: ModelConfig, spec: LayerSpec, up, shared,
                    i: int) -> bool:
    """Whether unit position ``i`` (``spec``) is a GQA block whose
    gathered weights (``up``, the unit's; ``shared``, zamba2's shared
    block) hold fewer than the model's KV heads: it computes the rank's
    heads, on a cache view of those heads."""
    if spec.mixer not in ("attn", "shared_attn"):
        return False
    p = shared["mixer"] if spec.mixer == "shared_attn" \
        else up[f"layer_{i}"]["mixer"]
    return p["wk"].shape[-1] < cfg.n_kv_heads * cfg.head_dim


def _local_caches(layer_caches, keep_kv: bool, heads: List[bool]):
    """One layer's DTensor caches as the tensors its mixer updates in
    place: each leaf gathered to this rank's batch rows whole along its
    other dims (a view, where it is sharded on the batch alone), and a
    function that writes the updated rows back into the stored shards.
    Where ``heads[i]`` holds, unit position ``i``'s ``k`` and ``v`` are
    this rank's KV heads instead (:func:`sharding.kv_heads_local`: a
    prefill's GQA block computing its heads).  With ``keep_kv`` (a
    flash-decode step) attention's ``k`` and ``v`` and MLA's ``latent``
    and ``k_rope`` stay DTensors where their sequence is sharded: the
    decode cores reduce each rank's own positions (a sequence that does
    not divide the ranks is replicated by the rules, and gathered as any
    other leaf)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    backs = []

    def local(name, c, by_heads):
        if by_heads and name in ("k", "v") and is_dtensor(c):
            view, back = kv_heads_local(c)
            backs.append(back)
            return view
        if not is_dtensor(c) or (
                keep_kv and cache_seq_dim(name) is not None
                and any(isinstance(p, Shard) and p.dim == cache_seq_dim(name)
                        for p in c.placements)):
            return c
        mesh = c.device_mesh
        rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in c.placements]
        if list(c.placements) == rows:
            return c.to_local()
        full = c.redistribute(mesh, rows).to_local()

        def back():
            lshape, off = compute_local_shape_and_global_offset(
                c.shape, mesh, c.placements)
            _ls, off_full = compute_local_shape_and_global_offset(
                c.shape, mesh, rows)
            part = full
            for d in range(full.ndim):
                part = part.narrow(d, off[d] - off_full[d], lshape[d])
            c.to_local().copy_(part)
        backs.append(back)
        return full

    out = [{k: local(k, c, h) for k, c in lc.items()}
           for lc, h in zip(layer_caches, heads)]

    def write_back():
        for back in backs:
            back()
    return out, write_back
