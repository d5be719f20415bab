"""Mixture-of-Experts FFN: top-k routing, three dispatch strategies.

The port of the reference package's ``models/moe.py``.

* ``sorted`` (default) — sort-based dispatch: the (token, k) assignments
  are stably sorted by expert id, truncated at per-expert capacity,
  scattered into an ``(E, C, D)`` buffer, pushed through batched expert
  GEMMs and combined.  Under a mesh of dp data ranks the reference sorts
  and truncates each of dp contiguous token shards alone, whenever the
  tokens divide the ranks.  The port does the same: where the batch's
  rows are split over the data axes each rank holds its own shard and
  sorts it alone; where they are not (the rows do not divide the ranks,
  every rank holds them all), each rank dispatches its own contiguous
  shard of the tokens and the shards' outputs are all-gathered
  (``distributed.sharding.gather_rows``, whose backward is the
  reduce-scatter).  Each shard's capacity is the shard's own.  The aux
  losses are the whole batch's, as the reference's: the per-expert
  fractions and mean router probabilities are averaged over the data
  axes before their product is formed.  The reference combines
  with a scatter-add over token ids; on the card ``index_add_`` uses
  atomics, whose order (and so whose bits) varies from run to run, so the
  port un-permutes instead: ``order`` is a permutation of the T·K
  assignments, each contribution goes back to its ``(T, K, D)`` slot, and
  the K of a token are summed in a fixed order.  It is the same sum.
* ``einsum`` — the GShard one-hot dispatch (three dense einsums), kept as
  the reference keeps it: its (T, E, C) dispatch tensor is only for tiny
  token counts.
* ``dropless`` — exact dense masked einsum over all experts; the serving
  path at decode (every expert's weights stream anyway once T·K ≳ E).

Aux losses (load balance and router z-loss) are returned for the train
loop.  JAX promotes a float32 × bfloat16 product to float32; PyTorch's
matmul refuses mixed dtypes, so the router's product is cast to float32
explicitly (the compute cast makes a stacked router bfloat16, as in the
reference).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..configs.base import ModelConfig, MoEConfig
from ..distributed.axes import current_mesh
from ..distributed.sharding import (data_mean, data_rank, data_size,
                                    gather_rows)
from .layers import Params, _normal, dense_init


def init_moe(cfg: ModelConfig, gen, dtype, device) -> nn.ParameterDict:
    """Parameters for one mixture-of-experts block: a float32 ``router``
    (D, E), the expert stacks ``w_gate``/``w_up`` (E, D, F) and ``w_down``
    (E, F, D), and with shared experts ``shared_gate``/``shared_up``
    (D, F·n_shared) and ``shared_down``."""
    m: MoEConfig = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_ff_expert
    scale = (2.0 / (D + Fe)) ** 0.5

    def experts(shape):
        w = _normal(shape, gen, dtype, device)
        if w.device.type != "meta":
            w.mul_(scale)
        return nn.Parameter(w, requires_grad=False)

    p = nn.ParameterDict({
        "router": dense_init(gen, D, E, torch.float32, device),
        "w_gate": experts((E, D, Fe)),
        "w_up": experts((E, D, Fe)),
        "w_down": experts((E, Fe, D)),
    })
    if m.n_shared:
        F_sh = Fe * m.n_shared
        p["shared_gate"] = dense_init(gen, D, F_sh, dtype, device)
        p["shared_up"] = dense_init(gen, D, F_sh, dtype, device)
        p["shared_down"] = dense_init(gen, F_sh, D, dtype, device)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert of the capacity dispatches: the reference's
    ``max(1, int(K·T·cf / E))``, in the same Python float arithmetic."""
    m: MoEConfig = cfg.moe
    return max(1, int(m.top_k * n_tokens * m.capacity_factor / m.n_experts))


def _expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """Batched per-expert SwiGLU: (E, C, D) -> (E, C, D)."""
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _dispatch_sorted(xt: torch.Tensor, gate_vals: torch.Tensor,
                     expert_idx: torch.Tensor, p: Params, *, n_experts: int,
                     cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch.  xt: (T, D); gate_vals/expert_idx:
    (T, K).  Stable-sorts the T·K assignments by expert, keeps the first
    ``cap`` of each expert, runs the batched expert GEMMs and combines ->
    (y (T, D), the number of assignments dropped at capacity, a 0-d
    tensor on the device)."""
    T, D = xt.shape
    K = expert_idx.shape[-1]
    E, C = n_experts, cap
    TK = T * K
    dev = xt.device

    flat_eid = expert_idx.reshape(TK)
    flat_gate = gate_vals.reshape(TK)
    order = torch.argsort(flat_eid, stable=True)           # (TK,)
    sorted_eid = flat_eid[order]
    # position of each assignment within its expert's run: its distance
    # from the run's first element (a running max of run-start indices)
    ar = torch.arange(TK, device=dev)
    starts = torch.ones(TK, dtype=torch.bool, device=dev)
    starts[1:] = sorted_eid[1:] != sorted_eid[:-1]
    run_start = torch.cummax(torch.where(starts, ar, 0), dim=0).values
    pos_in_expert = ar - run_start
    keep = pos_in_expert < C
    slot = torch.where(keep, sorted_eid * C + pos_in_expert, E * C)
    token_of = order // K                                   # (TK,)

    xe = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=dev)
    xe[slot] = xt[token_of]           # duplicates only in the drop slot
    ye = _expert_ffn(p, xe[:-1].reshape(E, C, D)).reshape(E * C, D)
    ye = torch.cat([ye, torch.zeros((1, D), dtype=ye.dtype, device=dev)])
    contrib = ye[slot] * (flat_gate[order] * keep)[:, None].to(ye.dtype)
    # un-permute: assignment order[j] is (token order[j] // K, k order[j] % K)
    per_k = torch.empty((TK, D), dtype=contrib.dtype, device=dev)
    per_k[order] = contrib
    y = per_k.reshape(T, K, D).sum(dim=1).to(xt.dtype)
    return y, TK - keep.sum()


def _shard_drops(expert_idx: torch.Tensor, n_shards: int, n_experts: int,
                 cap: int) -> torch.Tensor:
    """The assignments dropped at capacity ``cap`` in each of ``n_shards``
    contiguous token shards, summed (a 0-d tensor): per shard and expert,
    the assignments past the first ``cap``, from the routing alone."""
    TK = expert_idx.numel()
    dev = expert_idx.device
    shard = torch.arange(n_shards, device=dev).repeat_interleave(
        TK // n_shards)
    key = shard * n_experts + expert_idx.reshape(TK)
    counts = torch.zeros(n_shards * n_experts, dtype=torch.long,
                         device=dev).index_add_(0, key, torch.ones_like(key))
    return torch.clamp(counts - cap, min=0).sum()


def _dispatch_shards(cfg: ModelConfig, p: Params, xt: torch.Tensor,
                     gate_vals: torch.Tensor, expert_idx: torch.Tensor,
                     replicated_rows: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sorted dispatch of this call's T tokens as the reference lays
    it out on the ambient mesh's dp data ranks -> (y, dropped).  With
    ``replicated_rows`` (every rank holds the whole batch) and T % dp ==
    0, rank r dispatches tokens [r·T/dp, (r+1)·T/dp) at that shard's
    capacity and the shards' outputs are gathered; otherwise the T tokens
    (this rank's own rows, or a batch that does not divide) are one
    dispatch."""
    m: MoEConfig = cfg.moe
    mesh = current_mesh()
    T = xt.shape[0]
    dp = data_size(mesh)
    if not replicated_rows or dp == 1 or T % dp:
        return _dispatch_sorted(xt, gate_vals, expert_idx, p,
                                n_experts=m.n_experts, cap=capacity(cfg, T))
    Tl = T // dp
    cap = capacity(cfg, Tl)
    r = data_rank(mesh)
    mine = slice(r * Tl, (r + 1) * Tl)
    y, _ = _dispatch_sorted(xt[mine], gate_vals[mine], expert_idx[mine], p,
                            n_experts=m.n_experts, cap=cap)
    return (gather_rows(y, mesh),
            _shard_drops(expert_idx, dp, m.n_experts, cap))


def _shared(p: Params, xt: torch.Tensor) -> torch.Tensor:
    hs = F.silu(xt @ p["shared_gate"]) * (xt @ p["shared_up"])
    return hs @ p["shared_down"]


def _aux(m: MoEConfig, logits: torch.Tensor, probs: torch.Tensor,
         expert_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Switch-style load balance, E · Σ_e (fraction routed to e) · (mean
    router prob of e), and the router z-loss."""
    T, K = expert_idx.shape
    E = m.n_experts
    exp_oh = F.one_hot(expert_idx, E).to(torch.float32)
    me = torch.mean(probs, dim=0)
    fe = torch.sum(exp_oh, dim=(0, 1)) / (T * K)
    mesh = current_mesh()
    if mesh is not None:
        # a mesh's data ranks each hold T of the batch's rows: the whole
        # batch's fractions and means are the ranks' averages.  ``fe`` has
        # no gradient; ``me`` keeps its own rows' (each rank's loss counts
        # 1 / dp and the gradients are summed over the data axes, which
        # makes it the gradient of the whole batch's mean)
        fe = data_mean(fe, mesh)
        me = me + (data_mean(me, mesh) - me).detach()
    ce = E * torch.sum(fe * me)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return {"moe_load_balance": m.load_balance_coef * ce,
            "moe_z_loss": m.router_z_coef * z_loss}


#: calls of :func:`apply_moe` by dispatch since import (or since a caller
#: reset them to 0), and the assignments the ``sorted`` calls dropped at
#: capacity, every data shard's where a call splits its tokens into
#: shards (0, or a 0-d tensor on the device, so counting adds no host
#: synchronisation); counts for whoever reads them, nothing depends on them
dispatches = {"dropless": 0, "sorted": 0, "einsum": 0}
dropped = 0


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              dropless: bool = False, dispatch: str = "sorted",
              replicated_rows: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux losses).

    ``dropless=True`` (serving, decode): dense masked product over all
    experts, no drops.  ``dropless=False`` (training, a long prefill):
    capacity dispatch, ``dispatch="sorted"`` (default) or ``"einsum"``.
    ``replicated_rows``: on a mesh, ``x`` is the whole batch on every data
    rank (its rows did not divide the ranks), not this rank's rows; the
    sorted dispatch then splits the tokens into the reference's data
    shards (:func:`_dispatch_shards`).
    """
    global dropped
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    T = B * S
    xt = x.reshape(T, D)

    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                   # (T, E)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)    # (T, K)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    kind = "dropless" if dropless else dispatch
    if kind not in dispatches:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    dispatches[kind] += 1
    if dropless:
        gates = torch.zeros((T, E), dtype=xt.dtype, device=x.device)
        gates.scatter_add_(1, expert_idx, gate_vals.to(xt.dtype))
        h = F.silu(torch.matmul(xt, p["w_gate"])) \
            * torch.matmul(xt, p["w_up"])                   # (E, T, F)
        h = h * gates.T[:, :, None]
        y = torch.bmm(h, p["w_down"]).sum(dim=0)            # (T, D)
    elif dispatch == "sorted":
        y, n_dropped = _dispatch_shards(cfg, p, xt, gate_vals, expert_idx,
                                        replicated_rows)
        dropped = dropped + n_dropped
    else:
        y = _dispatch_einsum(cfg, p, xt, gate_vals, expert_idx)
    if m.n_shared:
        y = y + _shared(p, xt)
    return y.reshape(B, S, D), _aux(m, logits, probs, expert_idx)


def _dispatch_einsum(cfg: ModelConfig, p: Params, xt: torch.Tensor,
                     gate_vals: torch.Tensor,
                     expert_idx: torch.Tensor) -> torch.Tensor:
    """The GShard one-hot dispatch and combine."""
    m: MoEConfig = cfg.moe
    T, K = expert_idx.shape
    E = m.n_experts
    cap = capacity(cfg, T)
    # position of each (token, k) within its expert's capacity buffer
    onehot = F.one_hot(expert_idx, E)                       # (T, K, E)
    flat = onehot.reshape(T * K, E)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).reshape(T, K, E)
    pos = torch.sum(pos_in_expert * onehot, dim=-1)         # (T, K)
    keep = pos < cap
    kf = keep.to(xt.dtype)
    pos_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap] \
        .to(xt.dtype)                                       # (T, K, C)
    exp_oh = onehot.to(xt.dtype)
    dispatch = torch.einsum("tke,tkc->tec", exp_oh, pos_oh * kf[..., None])
    combine = torch.einsum("tke,tkc,tk->tec", exp_oh, pos_oh,
                           gate_vals.to(xt.dtype) * kf)
    xe = torch.einsum("tec,td->ecd", dispatch, xt)          # (E, C, D)
    return torch.einsum("tec,ecd->td", combine, _expert_ffn(p, xe))
