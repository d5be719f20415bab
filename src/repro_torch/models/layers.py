"""Shared neural layers: norms, RoPE/M-RoPE, MLPs, embeddings.

The port of the reference package's ``models/layers.py``.  Parameters are
``nn.ParameterDict``s with the reference's leaf names and layouts (dense
kernels are ``(d_in, d_out)``), and every ``apply_*`` takes any mapping of
name to tensor, so one function serves a module's parameters and a plain
dict of their compute-dtype copies.  Initializers draw from a
``torch.Generator`` with the reference's distributions (not its numbers).
Under a mesh (``distributed.axes.set_mesh``) :func:`constrain` is the
reference's sharding hint on a DTensor, and :func:`copy_to_model` /
:func:`reduce_from_model` are the two collectives around a
tensor-parallel block whose weights arrive as this rank's ``model`` shard
(``distributed.sharding.gather_for_compute``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..configs.base import ModelConfig
from ..distributed.axes import axis_names, current_mesh
from ..distributed.sharding import clean_spec, constrain_to, is_dtensor

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
    # under a mesh the hidden dim may be this rank's model shard
    width, full = p["w_up"].shape[-1], cfg.d_ff
    x = copy_to_model(x, width, full)
    if cfg.mlp == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        return reduce_from_model((F.silu(g) * u) @ p["w_down"], width, full)
    # the reference's jax.nn.gelu is the tanh approximation
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return reduce_from_model(h @ p["w_down"], width, full) + p["b_down"]


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
    rows = p["tokens"].shape[0]
    if rows == cfg.vocab_size:
        return p["tokens"][tokens]
    # on a mesh: this rank's rows of the vocabulary, the others' looked up
    # there and summed over the model group
    local = tokens - model_rank() * rows
    inside = (local >= 0) & (local < rows)
    out = p["tokens"][local.clamp(0, rows - 1)] \
        * inside[..., None].to(p["tokens"].dtype)
    return reduce_from_model(out, rows, cfg.vocab_size)


# ---------------------------------------------------------------------------
# sharding hints and the tensor-parallel collectives
# ---------------------------------------------------------------------------

DP = ("pod", "data")  # every data-parallel axis that may exist


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` against the ambient
    mesh: a no-op with no mesh or on a tensor that is not a DTensor;
    otherwise ``x`` is redistributed to the cleaned spec."""
    mesh = current_mesh()
    if mesh is None or not axis_names(mesh) or not is_dtensor(x):
        return x
    return constrain_to(x, clean_spec(tuple(x.shape), axes, mesh))


def model_rank() -> int:
    """This rank's coordinate on the ambient mesh's ``model`` axis."""
    mesh = current_mesh()
    if mesh is None or "model" not in axis_names(mesh):
        return 0
    return mesh.get_local_rank("model")


def vocab_parallel_terms(logits: torch.Tensor, targets: torch.Tensor,
                         vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logsumexp, target logit)`` over the whole vocabulary from this
    rank's columns of it (``logits[..., :V / m]`` of the model group's
    ``m`` ranks, in rank order): one max, one sum of exponentials and one
    target sum over the model group, never the full logits."""
    rows = logits.shape[-1]
    group = model_group()
    from torch.distributed import _functional_collectives as funcol
    m = funcol.wait_tensor(funcol.all_reduce(
        torch.amax(logits.detach(), dim=-1).contiguous(), "max", group))
    sum_exp = _ReduceFromModel.apply(
        torch.sum(torch.exp(logits - m[..., None]), dim=-1), group)
    lse = torch.log(sum_exp) + m
    local = targets - model_rank() * rows
    inside = (local >= 0) & (local < rows)
    picked = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])
    picked = _ReduceFromModel.apply(picked[..., 0] * inside, group)
    del vocab
    return lse, picked


def model_group():
    """The ambient mesh's ``model`` process group, or ``None``."""
    mesh = current_mesh()
    if mesh is None or "model" not in axis_names(mesh) \
            or not hasattr(mesh, "get_group"):
        return None
    return mesh.get_group("model")


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum", group))


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the ``model`` group
    (the input of a column-parallel block)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial outputs of a row-parallel block summed over the
    ``model`` group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, shard_width: int,
                  full_width: int) -> torch.Tensor:
    """``x`` entering a block whose weights are this rank's ``model``
    shard (``shard_width`` columns of ``full_width``); unchanged when the
    weights are whole."""
    group = model_group()
    if shard_width == full_width or group is None:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(y: torch.Tensor, shard_width: int,
                      full_width: int) -> torch.Tensor:
    """A row-parallel block's partial output summed over ``model``;
    unchanged when the weights are whole."""
    group = model_group()
    if shard_width == full_width or group is None:
        return y
    return _ReduceFromModel.apply(y, group)


def sum_over_model(s: torch.Tensor, shard_width: int,
                   full_width: int) -> torch.Tensor:
    """A statistic each rank forms from its ``shard_width`` of
    ``full_width`` channels (a partial sum), summed over ``model``, in
    the forward pass and in the backward: every rank reads the whole sum,
    but only for its own channels, so each holds a part of its gradient.
    Unchanged when the channels are whole."""
    return copy_to_model(reduce_from_model(s, shard_width, full_width),
                         shard_width, full_width)


def rms_project(yf: torch.Tensor, sq: torch.Tensor, full_width: int,
                scale: torch.Tensor, w: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``yf`` (float32, this rank's channels of ``full_width``) divided by
    the root mean square over all ``full_width`` channels, from ``sq``,
    their sum of squares (:func:`sum_over_model`), then scaled by
    ``scale``, cast to ``dtype`` and projected by ``w``: a recurrent
    block's gated RMSNorm and its out-projection, the rank's partial
    output where ``w`` holds its rows."""
    yf = yf * torch.rsqrt(sq / full_width + 1e-6) * scale.to(torch.float32)
    return yf.to(dtype) @ w


def write_heads(dst: torch.Tensor, part: torch.Tensor, dim: int,
                start: int) -> None:
    """Write ``part``, this rank's slice of ``dst`` along ``dim`` from
    ``start``, into ``dst`` in place.  On a ``model`` group every rank's
    slice is all-gathered (in rank order), so each rank holds the whole;
    with no group the slice alone is written (one rank's shard computed
    on its own, ``distributed.sharding.model_shard``).  Forward only: a
    serving state's heads."""
    group = model_group()
    if part.shape[dim] != dst.shape[dim] and group is not None:
        ops = torch.ops._c10d_functional
        part = ops.wait_tensor(ops.all_gather_into_tensor(
            part.movedim(dim, 0).contiguous(), group.size(),
            group.group_name)).movedim(0, dim)
    if part.shape[dim] == dst.shape[dim]:
        dst.copy_(part)
    else:
        dst.narrow(dim, start, part.shape[dim]).copy_(part)


def unembed(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """-> (B, S, V) or (B, K, S, V) logits, float32."""
    if cfg.n_codebooks == 1:
        # on a mesh the table's rows / the head's columns may be this
        # rank's vocabulary shard (the loss reduces over the model group)
        cols = (p["tokens"].shape[0] if cfg.tie_embeddings
                else p["head"].shape[-1])
        x = copy_to_model(x, cols, cfg.vocab_size)
    if cfg.tie_embeddings:
        logits = x @ p["tokens"].to(x.dtype).T
    elif cfg.n_codebooks > 1:
        logits = torch.einsum("bsd,kdv->bksv", x, p["head"].to(x.dtype))
    else:
        logits = x @ p["head"].to(x.dtype)
    logits = logits.to(torch.float32)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.n_codebooks > 1:
        return constrain(logits, DP, None, None, "model")
    return constrain(logits, DP, None, "model")
