"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of the reference package's ``models/xlstm.py``.  mLSTM is a
linear-attention-like cell with a per-head matrix memory C (dk × dv), a
normalizer n, a causal conv on the q/k path and a gated output; sLSTM keeps
per-unit scalar memories with a block-diagonal recurrence and is
sequential.  As in the reference, the exponential input gate is a sigmoid
gate, which makes the chunked parallel form (the SSD algebra with an extra
normalizer channel) safe without a running-max stabilizer.

Without a state (a cache-less forward) mLSTM runs the chunked form; with a
state (a serving step, prefill or decode) it runs the per-token recurrence
on a float32 C (B, H, dh, dh + 1), as the reference does: the chunked form
from an initial state would be a function the reference does not have.
sLSTM always steps token by token.  A state is updated in place (the
reference returns new arrays), as ``ssm.apply_mamba2``'s is.

JAX promotes a float32 × bfloat16 product to float32 where PyTorch's
matmul refuses it; the products that meet a float32 gate or state are cast
to float32 explicitly (elementwise sums promote alike in both).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..configs.base import ModelConfig, XLSTMConfig
from .layers import (Params, _normal, copy_to_model, dense_init, model_rank,
                     reduce_from_model, rms_project, sum_over_model,
                     write_heads)
from .ssm import _causal_conv

State = Dict[str, torch.Tensor]


def _scaled_normal(shape, scale: float, gen, dtype, device) -> nn.Parameter:
    w = _normal(shape, gen, dtype, device)
    if w.device.type != "meta":
        w.mul_(scale)
    return nn.Parameter(w, requires_grad=False)


def _f32(values: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(values.to(device=device, dtype=torch.float32),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig):
    x: XLSTMConfig = cfg.xlstm
    d_inner = int(x.mlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    dh = d_inner // H
    return x, d_inner, H, dh


def init_mlstm(cfg: ModelConfig, gen, dtype, device) -> nn.ParameterDict:
    """Parameters for one mLSTM block: ``w_up`` (D, 2 d_inner), ``conv``
    (W, d_inner), the block-diagonal ``w_q``/``w_k``/``w_v`` (H, dh, dh),
    ``w_gates`` (d_inner, 2H), a float32 ``gate_bias`` (input gates 0,
    forget gates 3), ``norm_scale`` and ``w_down``."""
    x, d_inner, H, dh = _mlstm_dims(cfg)
    scale = (1.0 / dh) ** 0.5
    gate_bias = torch.cat([torch.zeros((H,)), 3.0 * torch.ones((H,))])
    return nn.ParameterDict({
        "w_up": dense_init(gen, cfg.d_model, 2 * d_inner, dtype, device),
        "conv": _scaled_normal((x.conv_width, d_inner), 0.1, gen, dtype,
                               device),
        "w_q": _scaled_normal((H, dh, dh), scale, gen, dtype, device),
        "w_k": _scaled_normal((H, dh, dh), scale, gen, dtype, device),
        "w_v": _scaled_normal((H, dh, dh), scale, gen, dtype, device),
        "w_gates": dense_init(gen, d_inner, 2 * H, dtype, device),
        "gate_bias": _f32(gate_bias, device),
        "norm_scale": nn.Parameter(
            torch.ones((d_inner,), dtype=dtype, device=device),
            requires_grad=False),
        "w_down": dense_init(gen, d_inner, cfg.d_model, dtype, device),
    })


def _mlstm_chunked(q, k, v, log_f, log_i, chunk: int) -> torch.Tensor:
    """Chunked parallel mLSTM.  q, k, v: (B, L, H, dh); gates: (B, L, H).

    Weight(t, s) = exp(F_t - F_s + log i_s), F = cumsum(log f): the SSD
    chunk decomposition; the normalizer n_t·q_t comes from a ones-channel
    appended to v.  -> float32 (B, L, H, dh).
    """
    B, L, H, dh = q.shape
    c = min(chunk, L)
    Lp = -(-L // c) * c
    if Lp != L:
        pad3 = (0, 0, 0, 0, 0, Lp - L)
        q, k, v = F.pad(q, pad3), F.pad(k, pad3), F.pad(v, pad3)
        log_f = F.pad(log_f, (0, 0, 0, Lp - L))
        # padded tokens contribute nothing
        log_i = F.pad(log_i, (0, 0, 0, Lp - L), value=-1e30)
    nc = Lp // c
    f32 = torch.float32
    shp = (B, nc, c, H)
    qc = q.reshape(B, nc, c, H, dh).to(f32)
    kc = k.reshape(B, nc, c, H, dh).to(f32)
    vc = torch.cat([v.to(f32), torch.ones((*v.shape[:3], 1), dtype=f32,
                                          device=v.device)], dim=-1
                   ).reshape(B, nc, c, H, dh + 1)
    lf = log_f.reshape(shp).to(f32)
    li = log_i.reshape(shp).to(f32)

    Fc = torch.cumsum(lf, dim=2)                        # (B, nc, c, H)
    # intra-chunk: M[t, s] = exp(F_t - F_s + li_s), s <= t
    seg = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + li[:, :, None, :, :]
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    M = torch.where(tril[None, None, :, :, None], torch.exp(seg), 0.0)
    S = torch.einsum("bnthd,bnshd->bntsh", qc, kc) / (dh ** 0.5)
    y_intra = torch.einsum("bntsh,bntsh,bnshe->bnthe", S, M, vc)

    # inter-chunk: state C (dk, dv + 1); in-weights exp(F_c - F_s + li_s)
    w_in = torch.exp(Fc[:, :, -1:, :] - Fc + li)        # (B, nc, c, H)
    chunk_state = torch.einsum("bnsh,bnshd,bnshe->bnhde", w_in, kc, vc)
    chunk_decay = torch.exp(Fc[:, :, -1, :])            # (B, nc, H)
    Cst = torch.zeros((B, H, dh, dh + 1), dtype=f32, device=q.device)
    c_in = []
    for n in range(nc):
        c_in.append(Cst)                                # state BEFORE chunk
        Cst = Cst * chunk_decay[:, n, :, None, None] + chunk_state[:, n]
    C_in = torch.stack(c_in, dim=1)                     # (B, nc, H, dh, dv+1)
    y_state = torch.einsum("bnthd,bnhde,bnth->bnthe", qc, C_in,
                           torch.exp(Fc)) / (dh ** 0.5)
    y = (y_intra + y_state).reshape(B, Lp, H, dh + 1)[:, :L]
    num, den = y[..., :dh], y[..., dh]
    return num / torch.clamp(torch.abs(den), min=1.0)[..., None]


def _mlstm_recurrent(q, k, v, log_f, log_i, C: torch.Tensor) -> torch.Tensor:
    """The per-token mLSTM recurrence from the float32 state ``C`` (B, H,
    dh, dh + 1), which it updates in place: C = f C + i k (v, 1)^T, y =
    q C / sqrt(dh), h = num / max(|den|, 1).  q, k, v: (B, S, H, dh)
    float32; gates (B, S, H) -> (B, S, H, dh).

    Three launches a token: C scaled by f, the outer product of ``i k``
    and ``(v, 1)`` added in place (``baddbmm_``), and ``q C`` written into
    a buffer; the gates, the ones-channel and the normalisation are
    formed for all tokens at once outside the loop."""
    B, S, H, dh = q.shape
    f32 = torch.float32
    f = torch.exp(log_f).transpose(0, 1).contiguous()       # (S, B, H)
    ki = (k * torch.exp(log_i)[..., None]).transpose(0, 1).reshape(
        S, B * H, dh, 1)
    v_ext = torch.cat([v, torch.ones((B, S, H, 1), dtype=f32,
                                     device=v.device)], dim=-1)
    v_ext = v_ext.transpose(0, 1).reshape(S, B * H, 1, dh + 1)
    qs = q.transpose(0, 1).reshape(S, B * H, 1, dh)
    flat = C.view(B * H, dh, dh + 1)
    ys = torch.empty((S, B * H, 1, dh + 1), dtype=f32, device=q.device)
    for t in range(S):
        C.mul_(f[t, :, :, None, None])
        flat.baddbmm_(ki[t], v_ext[t])
        torch.bmm(qs[t], flat, out=ys[t])
    y = ys.view(S, B, H, dh + 1).transpose(0, 1) / (dh ** 0.5)
    return y[..., :dh] / torch.clamp(torch.abs(y[..., dh]),
                                     min=1.0)[..., None]


def apply_mlstm(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                     # (B, S, D)
    *,
    state: Optional[State] = None,       # {"C", "conv"}
) -> Tuple[torch.Tensor, Optional[State]]:
    """One mLSTM block, optionally carrying recurrent state (updated in
    place; the returned state is the same dict).

    Under a mesh ``p`` may hold this rank's heads alone
    (``distributed.sharding.gather_for_compute``: the x_m and z columns of
    ``w_up``, the channels of ``conv``, the rows of ``w_gates`` and
    ``w_down`` of its heads, its ``w_q``/``w_k``/``w_v`` and its gates'
    ``gate_bias``).  The gate pre-activations read every channel, so each
    rank's channels give a partial sum, summed over ``model``
    (``layers.sum_over_model``) before the rank takes its heads' input and
    forget gates; the norm's sum of squares is summed alike and one
    ``reduce_from_model`` sums ``hf @ w_down``.  The rank's ``model``
    coordinate places its heads among all the gates and in a whole
    state."""
    xcfg, d_inner, H, dh = _mlstm_dims(cfg)
    B, S, D = x.shape
    width = p["norm_scale"].shape[-1]
    Hl = width // dh
    off = model_rank() * Hl if Hl < H else 0
    cols = off * dh
    x = copy_to_model(x, width, d_inner)
    up = x @ p["w_up"]
    xm, z = up[..., :width], up[..., width:]
    conv_state = None
    if state is not None:
        conv_state = state["conv"][..., cols:cols + width]
    conv_out, new_conv = _causal_conv(xm, p["conv"], conv_state)
    conv_h = conv_out.reshape(B, S, Hl, dh)
    xm_h = xm.reshape(B, S, Hl, dh)
    q = torch.einsum("bshd,hde->bshe", conv_h, p["w_q"])
    k = torch.einsum("bshd,hde->bshe", conv_h, p["w_k"])
    v = torch.einsum("bshd,hde->bshe", xm_h, p["w_v"])
    gates = sum_over_model((conv_out @ p["w_gates"]).to(torch.float32),
                           width, d_inner)
    if Hl < H:
        gates = torch.cat([gates[..., off:off + Hl],
                           gates[..., H + off:H + off + Hl]], dim=-1)
    gates = gates + p["gate_bias"]
    log_i = F.logsigmoid(gates[..., :Hl])
    log_f = F.logsigmoid(gates[..., Hl:])

    if state is None:
        h = _mlstm_chunked(q, k, v, log_f, log_i, xcfg.chunk)
    else:
        f32 = torch.float32
        C = state["C"] if Hl == H else \
            state["C"][:, off:off + Hl].contiguous()
        h = _mlstm_recurrent(q.to(f32), k.to(f32), v.to(f32), log_f, log_i,
                             C)
        if Hl < H:
            write_heads(state["C"], C, 1, off)
        write_heads(state["conv"], new_conv, -1, cols)

    h = h.reshape(B, S, width)
    hf = h * F.silu(z.to(torch.float32))
    sq = sum_over_model(torch.sum(hf * hf, dim=-1, keepdim=True), width,
                        d_inner)
    out = rms_project(hf, sq, d_inner, p["norm_scale"], p["w_down"],
                      x.dtype)
    return reduce_from_model(out, width, d_inner), state


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> State:
    """Zeroed mLSTM recurrent state, float32: ``C`` (B, H, dh, dh + 1) and
    ``conv`` (B, W - 1, d_inner)."""
    xcfg, d_inner, H, dh = _mlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, H, dh, dh + 1), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, xcfg.conv_width - 1, d_inner),
                            dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, gen, dtype, device) -> nn.ParameterDict:
    """Parameters for one sLSTM block: ``w_x`` (D, 4D) for the i, f, z, o
    gates, the block-diagonal recurrence ``r_h`` (H, dh, 4 dh), a float32
    ``bias`` (4D), ``norm_scale``, and the gated up/down projection
    ``w_up_gate``, ``w_up`` (D, d_up) and ``w_down``."""
    x: XLSTMConfig = cfg.xlstm
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    d_up = int(x.slstm_proj_factor * D)
    return nn.ParameterDict({
        "w_x": dense_init(gen, D, 4 * D, dtype, device),
        "r_h": _scaled_normal((H, dh, 4 * dh), 0.1, gen, dtype, device),
        "bias": _f32(torch.zeros((4 * D,)), device),
        "norm_scale": nn.Parameter(
            torch.ones((D,), dtype=dtype, device=device),
            requires_grad=False),
        "w_up_gate": dense_init(gen, D, d_up, dtype, device),
        "w_up": dense_init(gen, D, d_up, dtype, device),
        "w_down": dense_init(gen, d_up, D, dtype, device),
    })


def _slstm_step(r_h: torch.Tensor, dh: int, carry, gx_t):
    """One recurrent step.  carry: (c, n, h), each (B, H, dh) float32;
    r_h float32."""
    c, n, h = carry
    rec = torch.einsum("bhd,hde->bhe", h, r_h)
    g = gx_t + rec                                     # (B, H, 4 dh)
    i = torch.sigmoid(g[..., :dh])
    f = torch.sigmoid(g[..., dh:2 * dh] + 2.0)
    z = torch.tanh(g[..., 2 * dh:3 * dh])
    o = torch.sigmoid(g[..., 3 * dh:])
    c = f * c + i * z
    n = f * n + i
    h = o * c / torch.clamp(n, min=1.0)
    return (c, n, h), h


def apply_slstm(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                     # (B, S, D)
    *,
    state: Optional[State] = None,       # {"c", "n", "h"}
    cost_proxy: bool = False,
) -> Tuple[torch.Tensor, Optional[State]]:
    """One sLSTM layer, optionally carrying recurrent state (updated in
    place; the returned state is the same dict).

    ``cost_proxy=True`` replaces the sequential scan with the reference's
    cost-equivalent dense computation (the same matmul shapes × S), which
    only its dry-run FLOP coster uses; never for real outputs."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    B, S, _ = x.shape
    gx = (x @ p["w_x"]).to(torch.float32) + p["bias"]
    gx = gx.reshape(B, S, H, 4 * dh)
    r_h = p["r_h"].to(torch.float32)

    if cost_proxy:
        # the same per-step recurrent matmul cost, in a parallel shape
        rec = torch.einsum("bshd,hde->bshe", gx[..., :dh], r_h)
        h_seq = torch.tanh((gx + rec)[..., :dh])
        new_state = None
    else:
        if state is None:
            c0 = torch.zeros((B, H, dh), dtype=torch.float32,
                             device=x.device)
            carry = (c0, c0, c0)
        else:
            carry = (state["c"], state["n"], state["h"])
        hs = []
        for t in range(S):
            carry, h_t = _slstm_step(r_h, dh, carry, gx[:, t])
            hs.append(h_t)
        h_seq = torch.stack(hs, dim=1)                 # (B, S, H, dh)
        new_state = state
        if state is not None:
            for name, value in zip(("c", "n", "h"), carry):
                state[name].copy_(value)

    h = h_seq.reshape(B, S, D)
    ms = torch.mean(h * h, dim=-1, keepdim=True)
    h = (h * torch.rsqrt(ms + 1e-6)
         * p["norm_scale"].to(torch.float32)).to(x.dtype)
    up = F.gelu(h @ p["w_up_gate"], approximate="tanh") * (h @ p["w_up"])
    return up @ p["w_down"], new_state


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> State:
    """Zeroed sLSTM recurrent state, float32: ``c``, ``n``, ``h`` (B, H,
    dh)."""
    D, H = cfg.d_model, cfg.n_heads
    return {name: torch.zeros((batch, H, D // H), dtype=torch.float32,
                              device=device)
            for name in ("c", "n", "h")}
