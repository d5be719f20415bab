"""Shared neural layers: norms, RoPE/M-RoPE, MLPs, embeddings.

The port of the reference package's ``models/layers.py``.  Parameters are
``nn.ParameterDict``s with the reference's leaf names and layouts (dense
kernels are ``(d_in, d_out)``), and every ``apply_*`` takes any mapping of
name to tensor, so one function serves a module's parameters and a plain
dict of their compute-dtype copies.  Initializers draw from a
``torch.Generator`` with the reference's distributions (not its numbers).
The reference's ``constrain`` (GSPMD sharding hints) has no counterpart:
the port has no mesh.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..configs.base import ModelConfig

Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------

def _normal(shape, gen: Optional[torch.Generator], dtype, device):
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def dense_init(gen, d_in: int, d_out: int, dtype, device) -> nn.Parameter:
    """A dense kernel of shape ``(d_in, d_out)``: N(0, 2 / (d_in + d_out))."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = _normal((d_in, d_out), gen, dtype, device)
    if w.device.type != "meta":
        w.mul_(scale)
    return nn.Parameter(w, requires_grad=False)


def embed_init(gen, vocab: int, d: int, dtype, device) -> nn.Parameter:
    """An embedding table of shape ``(vocab, d)``: N(0, 1)."""
    return nn.Parameter(_normal((vocab, d), gen, dtype, device),
                        requires_grad=False)


def _const(shape, value: float, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: int, dtype, device) -> nn.ParameterDict:
    """Parameters for one normalization site."""
    p = nn.ParameterDict({"scale": _const((d,), 1.0, dtype, device)})
    if cfg.norm == "layernorm":
        p["bias"] = _const((d,), 0.0, dtype, device)
    return p


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Apply the configured normalization, in float32, cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (+ M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None) -> Tuple[torch.Tensor, int]:
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) integer.  Computed in float32,
    cast back to x's dtype."""
    D = x.shape[-1]
    inv, rot = rope_freqs(D, theta, fraction, device=x.device)
    ang = positions[:, None, :, None].to(torch.float32) * inv  # (B,1,S,rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1) if rot < D \
        else y.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: (t, h, w) position triplets.

    x: (B, H, S, D); positions3: (B, 3, S).  The D/2 frequency slots are
    partitioned into ``sections`` (t, h, w); each slot rotates by the
    position along its assigned axis.
    """
    D = x.shape[-1]
    half = D // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    sec_idx = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device))         # (half,)
    pos = positions3.to(torch.float32)[:, sec_idx, :]    # (B, half, S)
    ang = pos.transpose(1, 2) * inv[None, None, :]       # (B, S, half)
    cos = torch.cos(ang)[:, None, :, :]
    sin = torch.sin(ang)[:, None, :, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen, d: int, d_ff: int, dtype,
             device) -> nn.ParameterDict:
    """Parameters for one (gated) MLP block."""
    if cfg.mlp == "swiglu":
        return nn.ParameterDict({
            "w_gate": dense_init(gen, d, d_ff, dtype, device),
            "w_up": dense_init(gen, d, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d, dtype, device),
        })
    return nn.ParameterDict({
        "w_up": dense_init(gen, d, d_ff, dtype, device),
        "b_up": _const((d_ff,), 0.0, dtype, device),
        "w_down": dense_init(gen, d_ff, d, dtype, device),
        "b_down": _const((d,), 0.0, dtype, device),
    })


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """One MLP block forward pass."""
    if cfg.mlp == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        return (F.silu(g) * u) @ p["w_down"]
    # the reference's jax.nn.gelu is the tanh approximation
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embeddings(cfg: ModelConfig, gen, dtype, device) -> nn.ParameterDict:
    """Token embedding and output-head parameters."""
    if cfg.n_codebooks > 1:
        emb = nn.Parameter(torch.stack([
            embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)
            for _ in range(cfg.n_codebooks)
        ]), requires_grad=False)                              # (K, V, D)
    else:
        emb = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    p = nn.ParameterDict({"tokens": emb})
    if not cfg.tie_embeddings:
        if cfg.n_codebooks > 1:
            p["head"] = nn.Parameter(torch.stack([
                dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, device)
                for _ in range(cfg.n_codebooks)
            ]), requires_grad=False)                          # (K, D, V)
        else:
            p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype,
                                   device)
    return p


def embed_tokens(cfg: ModelConfig, p: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) or (B, K, S) for multi-codebook audio."""
    if cfg.n_codebooks > 1:
        out = torch.zeros((tokens.shape[0], tokens.shape[2], cfg.d_model),
                          dtype=p["tokens"].dtype, device=tokens.device)
        for kbook in range(cfg.n_codebooks):
            out = out + p["tokens"][kbook][tokens[:, kbook]]
        return out
    return p["tokens"][tokens]


def unembed(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """-> (B, S, V) or (B, K, S, V) logits, float32."""
    if cfg.tie_embeddings:
        logits = x @ p["tokens"].to(x.dtype).T
    elif cfg.n_codebooks > 1:
        logits = torch.einsum("bsd,kdv->bksv", x, p["head"].to(x.dtype))
    else:
        logits = x @ p["head"].to(x.dtype)
    logits = logits.to(torch.float32)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
