"""Mamba-2 (SSD) mixer block: the zamba2 backbone.

The port of the reference package's ``models/ssm.py``.  Without a state
(a cache-less forward) the scan is the chunked SSD form in plain PyTorch
(``_chunked_ssd``) or, under ``impl="kernel"``, the hand-written CUDA
kernel ``kernels/csrc/mamba2_scan.cu`` (its plain version on a CPU
tensor).  A serving step carries an explicit (B, H, P, N) state and a
rolling window of the last W - 1 conv inputs.  The reference sends every
step with a state to its sequential recurrence, because its TPU kernel
starts from zeros; the port's kernel starts from the given state, so
under ``impl="kernel"`` prefill and decode both go through it:

  ============  ========================  ==============================
  impl          no state                  with a state
  ============  ========================  ==============================
  ``"kernel"``  ``ops.mamba2_scan``       ``ops.mamba2_scan(h0=...)``
  others        ``_chunked_ssd``          ``ref.mamba2_scan(h0=...)``
                (``"chunked"``), else
                ``ref.mamba2_scan``
  ============  ========================  ==============================
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..configs.base import ModelConfig, SSMConfig
from ..kernels import ops as kops
from ..kernels import ref as kref
from .layers import (Params, _normal, copy_to_model, dense_init, model_rank,
                     reduce_from_model, rms_project, sum_over_model,
                     write_heads)


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return s, d_inner, n_heads


def init_mamba2(cfg: ModelConfig, gen, dtype, device) -> nn.ParameterDict:
    """Parameters for one Mamba-2 block, in the reference's layouts: the
    fused input projection ``w_in`` (D, 2 d_inner + 2N + H) in the order
    [z (gate), x, B, C, dt], the depthwise ``conv`` (W, d_inner + 2N),
    ``A_log``, ``D``, ``dt_bias`` (H,), ``w_out`` and ``norm_scale``."""
    s, d_inner, H = _dims(cfg)
    N = s.d_state
    d_proj = 2 * d_inner + 2 * N + H
    conv = _normal((s.conv_width, d_inner + 2 * N), gen, dtype, device)
    if conv.device.type != "meta":
        conv.mul_(0.1)

    def f32(values: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(values.to(device=device, dtype=torch.float32),
                            requires_grad=False)

    return nn.ParameterDict({
        "w_in": dense_init(gen, cfg.d_model, d_proj, dtype, device),
        "conv": nn.Parameter(conv, requires_grad=False),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, H))),
        "D": f32(torch.ones((H,))),
        "dt_bias": f32(torch.log(torch.expm1(torch.full((H,), 0.01)))),
        "w_out": dense_init(gen, d_inner, cfg.d_model, dtype, device),
        "norm_scale": nn.Parameter(
            torch.ones((d_inner,), dtype=dtype, device=device),
            requires_grad=False),
    })


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. u: (B, L, C); w: (W, C).

    Returns (y, new_state) where state is the last W-1 inputs (for decode).
    """
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)                  # (B, L+W-1, C)
    y = sum(ext[:, i:i + u.shape[1]] * w[i][None, None] for i in range(W))
    new_state = ext[:, -(W - 1):] if W > 1 else torch.zeros_like(pad)
    return F.silu(y), new_state


def _chunked_ssd(x, dt, A, Bm, Cm, chunk: int):
    """Plain chunked SSD, line for line after the reference's
    ``_chunked_ssd_jnp``.  x: (B, L, H, P), dt: (B, L, H), A: (H,),
    Bm/Cm: (B, L, N); zero initial state -> y in x's dtype."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    c = min(chunk, L)
    Lp = -(-L // c) * c
    if Lp != L:
        x = F.pad(x, (0, 0, 0, 0, 0, Lp - L))
        dt = F.pad(dt, (0, 0, 0, Lp - L))
        Bm = F.pad(Bm, (0, 0, 0, Lp - L))
        Cm = F.pad(Cm, (0, 0, 0, Lp - L))
    nc = Lp // c
    f32 = torch.float32
    xc = x.reshape(B, nc, c, H, P).to(f32)
    dtc = dt.reshape(B, nc, c, H).to(f32)
    Bc = Bm.reshape(B, nc, c, N).to(f32)
    Cc = Cm.reshape(B, nc, c, N).to(f32)

    a = A[None, None, None, :] * dtc                    # (B, nc, c, H)
    Lcum = torch.cumsum(a, dim=2)
    seg = Lcum[:, :, :, None, :] - Lcum[:, :, None, :, :]   # (B,nc,c,c,H)
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    M = torch.where(tril[None, None, :, :, None],
                    torch.exp(seg) * dtc[:, :, None, :, :], 0.0)
    CB = torch.einsum("bnti,bnsi->bnts", Cc, Bc)        # (B, nc, c, c)
    y_intra = torch.einsum("bnts,bntsh,bnshp->bnthp", CB, M, xc)

    # inter-chunk state carry (sequential over nc chunks only)
    w = torch.exp(Lcum[:, :, -1:, :] - Lcum) * dtc      # (B, nc, c, H)
    chunk_state = torch.einsum("bnsh,bnshp,bnsi->bnhpi", w, xc, Bc)
    chunk_decay = torch.exp(Lcum[:, :, -1, :])          # (B, nc, H)
    h = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    h_in = []
    for n in range(nc):
        h_in.append(h)                                  # state BEFORE chunk
        h = h * chunk_decay[:, n, :, None, None] + chunk_state[:, n]
    h_in = torch.stack(h_in, dim=1)                     # (B, nc, H, P, N)
    y_state = torch.einsum("bnti,bnhpi,bnth->bnthp",
                           Cc, h_in, torch.exp(Lcum))
    y = (y_intra + y_state).reshape(B, Lp, H, P)[:, :L]
    return y.to(x.dtype)


def apply_mamba2(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                  # (B, S, D)
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,  # {"ssm", "conv"}
    impl: str = "chunked",
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One Mamba-2 block, optionally carrying decode state.

    With a ``state`` the new SSM state and conv window are copied into
    ``state["ssm"]`` and ``state["conv"]`` in place (the reference returns
    new arrays), and the returned state is the same dict; the caches keep
    their float32 type.

    Under a mesh ``p`` may hold this rank's heads alone
    (``distributed.sharding.gather_for_compute``: the z, x and dt columns
    of ``w_in`` and the x channels of ``conv`` of its heads, ``B`` and
    ``C`` whole, its rows of ``w_out``): the rank scans its H/m heads
    (:func:`mamba2_mix`), the gated norm's sum of squares is summed over
    ``model`` (``layers.sum_over_model``) and one ``reduce_from_model``
    sums ``yf @ w_out``."""
    d_inner = _dims(cfg)[1]
    width = p["norm_scale"].shape[-1]
    x = copy_to_model(x, width, d_inner)
    yf, sq, new_state = mamba2_mix(cfg, p, x, state=state, impl=impl)
    sq = sum_over_model(sq, width, d_inner)
    out = rms_project(yf, sq, d_inner, p["norm_scale"], p["w_out"], x.dtype)
    return reduce_from_model(out, width, d_inner), new_state


def mamba2_mix(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,
    impl: str = "chunked",
    head_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The block up to its gated norm, on the heads ``p`` holds (all, or
    a rank's, :func:`apply_mamba2`) -> (the gated output ``yf``, float32
    (B, S, w) over those heads' w channels; its sum of squares over them,
    (B, S, 1); the state).  Those heads' slice of a ``state`` is read
    and written back (``layers.write_heads``); ``head_offset`` (default:
    the rank's ``model`` coordinate times H/m) places them there."""
    s, d_inner, H = _dims(cfg)
    N, P = s.d_state, s.head_dim
    B, S, D = x.shape
    width, Hl = p["norm_scale"].shape[-1], p["A_log"].shape[-1]
    off = 0
    if Hl < H:
        off = model_rank() * Hl if head_offset is None else head_offset
    cols = off * P

    proj = x @ p["w_in"]
    z, xin, Bm, Cm, dt_raw = torch.split(
        proj, [width, width, N, N, Hl], dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_state = h0 = None
    if state is not None:
        conv_state, h0 = state["conv"], state["ssm"]
        if Hl < H:
            conv_state = torch.cat([conv_state[..., cols:cols + width],
                                    conv_state[..., d_inner:]], dim=-1)
            h0 = h0[:, off:off + Hl]
    conv_out, new_conv = _causal_conv(conv_in, p["conv"], conv_state)
    xin, Bm, Cm = torch.split(conv_out, [width, N, N], dim=-1)

    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])    # (B,S,Hl)
    A = -torch.exp(p["A_log"])                        # (Hl,) negative
    xh = xin.reshape(B, S, Hl, P)      # a view: strided over S

    if impl == "kernel":
        y, h = kops.mamba2_scan(xh, dt, A, Bm, Cm, h0=h0)
    elif state is not None:
        y, h = kref.mamba2_scan(xh, dt, A, Bm, Cm, h0=h0)
    elif impl == "chunked":
        y = _chunked_ssd(xh, dt, A, Bm, Cm, s.chunk)
    else:
        y, _ = kref.mamba2_scan(xh, dt, A, Bm, Cm)
    if state is not None:
        write_heads(state["ssm"], h, 1, off)
        write_heads(state["conv"][..., :d_inner], new_conv[..., :width], -1,
                    cols)
        state["conv"][..., d_inner:].copy_(new_conv[..., width:])

    y = y + p["D"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(B, S, width).to(x.dtype)
    # gated RMSNorm (Mamba2 norm-before-out): the gate here, the norm in
    # layers.rms_project
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    return yf, torch.sum(yf * yf, dim=-1, keepdim=True), state


def init_mamba2_state(cfg: ModelConfig, batch: int,
                      device) -> Dict[str, torch.Tensor]:
    """Zeroed Mamba-2 decode state, float32: ``ssm`` (B, H, P, N) and
    ``conv`` (B, W - 1, d_inner + 2N)."""
    s, d_inner, H = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, d_inner + 2 * s.d_state),
                            dtype=torch.float32, device=device),
    }
