"""Mixture-of-Experts FFN: top-k routing, three dispatch strategies.

The port of the reference package's ``models/moe.py``.

* ``sorted`` (default) — sort-based dispatch: the (token, k) assignments
  are stably sorted by expert id, truncated at per-expert capacity,
  gathered into an ``(E, C, D)`` buffer, pushed through batched expert
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
  port gathers instead: each token reads its K slots in turn and sums
  them in a fixed order.  It is the same sum.
* ``einsum`` — the GShard one-hot dispatch (three dense einsums), kept as
  the reference keeps it: its (T, E, C) dispatch tensor is only for tiny
  token counts.
* ``dropless`` — exact dense masked einsum over all experts; the serving
  path at decode (every expert's weights stream anyway once T·K ≳ E).

Expert parallelism, as the reference's rules lay the experts out: on a
mesh whose ``model`` axis of m ranks shards the expert stacks, each rank
holds and computes E/m experts (the buffers of a dispatch are 1/m of the
whole one's), the routing is computed whole on every rank, and one
``reduce_from_model`` a layer sums the partial outputs.

Aux losses (load balance and router z-loss) are returned for the train
loop.  JAX promotes a float32 × bfloat16 product to float32; PyTorch's
matmul refuses mixed dtypes, so the router's product is cast to float32
explicitly (the compute cast makes a stacked router bfloat16, as in the
reference).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..configs.base import ModelConfig, MoEConfig
from ..distributed.axes import current_mesh
from ..distributed.sharding import (data_mean, data_rank, data_size,
                                    gather_rows)
from .layers import (Params, _normal, copy_to_model, dense_init, model_rank,
                     reduce_from_model)


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
                     cap: int, expert_offset: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch.  xt: (T, D); gate_vals/expert_idx:
    (T, K).  Stable-sorts the T·K assignments by expert and keeps the
    first ``cap`` of each expert's run: the sort and the capacity cover
    all ``n_experts``, so every ``model`` rank drops the same assignments.
    The buffer holds only ``p``'s E_l experts from ``expert_offset`` on,
    (E_l, C, D), each slot gathered from its token; after the batched
    expert GEMMs each token gathers its K slots in turn, zero where an
    assignment is another rank's or dropped, and sums them in float32 in
    that fixed order (no scatter-add, no atomics) -> (this rank's
    experts' y (T, D), the number of assignments dropped at capacity, a
    0-d tensor on the device)."""
    T, D = xt.shape
    K = expert_idx.shape[-1]
    E, C = n_experts, cap
    El, e0 = p["w_gate"].shape[0], expert_offset
    TK = T * K
    dev = xt.device

    flat_eid = expert_idx.reshape(TK)
    order = torch.argsort(flat_eid, stable=True)           # (TK,)
    sorted_eid = flat_eid[order]
    experts = torch.arange(E, device=dev, dtype=sorted_eid.dtype)
    first = torch.searchsorted(sorted_eid, experts)         # each run's start
    count = torch.searchsorted(sorted_eid, experts, right=True) - first
    # slot (e, c) of a local expert: the c-th assignment of e's run
    c = torch.arange(C, device=dev)
    filled = c < count[e0:e0 + El, None]                    # (El, C)
    src = torch.where(filled, first[e0:e0 + El, None] + c, 0)
    xe = xt[order[src] // K] * filled[..., None].to(xt.dtype)
    ye = _expert_ffn(p, xe).reshape(El * C, D)

    # each assignment's place in its expert's run (its sorted position
    # less the run's start), and its local slot where it has one
    sorted_pos = torch.empty_like(order)
    sorted_pos[order] = torch.arange(TK, device=dev)
    pos = sorted_pos - first[flat_eid]
    keep = pos < C
    local = keep & (flat_eid >= e0) & (flat_eid < e0 + El)
    slot = torch.where(local, (flat_eid - e0) * C + pos, 0).reshape(T, K)
    w = (gate_vals.reshape(TK) * local).reshape(T, K).to(ye.dtype)
    y = torch.zeros((T, D), dtype=torch.float32, device=dev)
    for k in range(K):
        y = y + (ye[slot[:, k]] * w[:, k, None]).to(torch.float32)
    return y.to(xt.dtype), TK - keep.sum()


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
              replicated_rows: bool = False,
              expert_offset: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux losses).

    ``dropless=True`` (serving, decode): dense masked product over all
    experts, no drops.  ``dropless=False`` (training, a long prefill):
    capacity dispatch, ``dispatch="sorted"`` (default) or ``"einsum"``.
    ``replicated_rows``: on a mesh, ``x`` is the whole batch on every data
    rank (its rows did not divide the ranks), not this rank's rows; where
    the tokens divide the dp data ranks, rank r then dispatches tokens
    [r·T/dp, (r+1)·T/dp) at that shard's capacity and the shards' outputs
    are gathered (``sharding.gather_rows``), as the reference sorts each
    data shard alone.

    Expert parallelism: ``p``'s expert stacks may hold E_l of the E
    experts, from ``expert_offset`` on (by default this rank's ``model``
    coordinate times E_l where E_l < E, else 0), and its shared experts their ``model`` shard
    of columns and rows (``distributed.sharding.gather_for_compute``).
    The router, top-k and aux losses run whole on every rank, so every
    rank routes alike; each dispatch computes the local experts only, and
    one ``reduce_from_model`` sums the partial outputs.  Without a model
    group that sum is the caller's: the partial output is returned.
    """
    global dropped
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    El = p["w_gate"].shape[0]
    if expert_offset is None:
        # stacks that hold every expert (a block the rules replicate, as
        # where E does not divide ``model``, or gathered whole) start at 0
        expert_offset = model_rank() * El if El < E else 0
    e0 = expert_offset
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
    # the region on this rank's experts: the router is whole on every
    # rank, but its gates (and the tokens) feed the local experts alone,
    # so their gradients are summed over the model group
    xe = copy_to_model(xt, El, E)
    gates = copy_to_model(gate_vals, El, E)
    shared_local = bool(m.n_shared) and \
        p["shared_gate"].shape[-1] < m.d_ff_expert * m.n_shared
    rows = slice(None)
    mesh = current_mesh()
    dp = data_size(mesh)
    shards = (kind == "sorted" and replicated_rows and dp > 1
              and T % dp == 0)
    if shards:
        Tl = T // dp
        r = data_rank(mesh)
        rows = slice(r * Tl, (r + 1) * Tl)
    if dropless:
        dense = torch.zeros((T, E), dtype=xt.dtype, device=x.device)
        dense.scatter_add_(1, expert_idx, gates.to(xt.dtype))
        h = F.silu(torch.matmul(xe, p["w_gate"])) \
            * torch.matmul(xe, p["w_up"])                   # (E_l, T, F)
        h = h * dense[:, e0:e0 + El].T[:, :, None]
        y = torch.bmm(h, p["w_down"]).sum(dim=0)            # (T, D)
    elif kind == "sorted":
        cap = capacity(cfg, T // dp if shards else T)
        y, n_dropped = _dispatch_sorted(
            xe[rows], gates[rows], expert_idx[rows], p, n_experts=E,
            cap=cap, expert_offset=e0)
        dropped = dropped + (_shard_drops(expert_idx, dp, E, cap)
                             if shards else n_dropped)
    else:
        y = _dispatch_einsum(cfg, p, xe, gates, expert_idx, e0)
    if shared_local:
        y = y + _shared(p, xe[rows])
    # one sum of the partial outputs over the model group; of a data
    # shard's rows before they are gathered, which moves 1 / dp of the
    # bytes a sum of the gathered (T, D) would
    y = reduce_from_model(y, El, E)
    if shards:
        y = gather_rows(y, mesh)
    if m.n_shared and not shared_local:
        y = y + _shared(p, xt)
    return y.reshape(B, S, D), _aux(m, logits, probs, expert_idx)


def _dispatch_einsum(cfg: ModelConfig, p: Params, xt: torch.Tensor,
                     gate_vals: torch.Tensor, expert_idx: torch.Tensor,
                     expert_offset: int = 0) -> torch.Tensor:
    """The GShard one-hot dispatch and combine, over ``p``'s E_l experts
    from ``expert_offset`` on (positions and capacity over all E)."""
    m: MoEConfig = cfg.moe
    T, K = expert_idx.shape
    E = m.n_experts
    local = slice(expert_offset, expert_offset + p["w_gate"].shape[0])
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
    exp_oh = onehot[..., local].to(xt.dtype)                # (T, K, E_l)
    dispatch = torch.einsum("tke,tkc->tec", exp_oh, pos_oh * kf[..., None])
    combine = torch.einsum("tke,tkc,tk->tec", exp_oh, pos_oh,
                           gate_vals.to(xt.dtype) * kf)
    xe = torch.einsum("tec,td->ecd", dispatch, xt)          # (E_l, C, D)
    return torch.einsum("tec,ecd->td", combine, _expert_ffn(p, xe))
