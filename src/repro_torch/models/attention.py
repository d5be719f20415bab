"""Attention mixers: GQA (with RoPE/M-RoPE, biases) and DeepSeek's MLA, the
cores, and their caches.

The port of the reference package's ``models/attention.py``.  Three
interchangeable cores:

* ``impl="kernel"``  — the hand-written CUDA flash-attention kernel
                       (``kernels/csrc/flash_attention.cu``), the
                       counterpart of the reference's ``"pallas"``; on a
                       CPU tensor its plain version runs instead
* ``impl="blocked"`` — online softmax over key blocks in plain PyTorch
* ``impl="naive"``   — materialized logits

The reference sends a call with ``kv_len`` (a serving step over a partly
filled cache) to its blocked core even under ``"pallas"``: under ``jit``
``kv_len`` is traced, so its kernel cannot be given a cache slice of static
length.  Here ``kv_len`` is a Python int, and the kernel runs on
``k[:, :, :kv_len]``, read in place through its strides.  With the causal
mask aligned to the end of the keys that is exactly the function the
blocked core computes with ``kv_len``: query i sees the keys < kv_len at
positions <= kv_len - Sq + i.  So prefill and decode both go through the
kernel.

MLA (:func:`apply_mla`) caches one latent of ``kv_lora_rank`` and one
shared RoPE key per token and expands them to per-head keys and values on
every call (the non-absorbed form), then pads v with zeros to the q/k width
(``qk_nope_head_dim + qk_rope_head_dim``) so that one core takes it, and
slices the output back, as the reference does.

Not ported: the mesh and costing cores (``_flash_decode_core``,
``_kernel_proxy_core``); they raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import MLAConfig, ModelConfig
from ..kernels import ops as kops
from .layers import Params, apply_mrope, apply_rope, dense_init

NEG_INF = -1e30
# the unported cores, with their ROADMAP "Modules to port" items
_LATER = {"flash_decode": "the mesh's flash-decode core is not ported yet: "
                          "item 8.3 (distributed)",
          "kernel_proxy": "the costing probe's core is not ported yet: "
                          "item 8.4 (launch tooling)"}


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _naive_core(q, k, v, *, causal: bool, scale: float,
                kv_len: Optional[int] = None) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    valid_len = Skv if kv_len is None else kv_len
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = kpos < valid_len
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (valid_len - Sq)
        mask = mask & (qpos >= kpos)
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def _blocked_core(q, k, v, *, causal: bool, scale: float, bk: int = 1024,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Online softmax over key blocks; never materializes (Sq, Skv).

    A Python loop over blocks of ``bk`` keys stands in for the reference's
    ``lax.scan``; the last block is zero-padded and masked, as there.
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    bk = min(bk, Skv)
    nk = -(-Skv // bk)
    qg = (q.reshape(B, Hkv, G, Sq, D) * scale).to(torch.float32)
    valid_len = Skv if kv_len is None else kv_len
    qpos = torch.arange(Sq, device=q.device)[:, None] + (valid_len - Sq)

    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    for j in range(nk):
        kj = k[:, :, j * bk:(j + 1) * bk].to(torch.float32)
        vj = v[:, :, j * bk:(j + 1) * bk].to(torch.float32)
        if kj.shape[2] < bk:
            pad = (0, 0, 0, bk - kj.shape[2])
            kj, vj = nn.functional.pad(kj, pad), nn.functional.pad(vj, pad)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj)
        kpos = j * bk + torch.arange(bk, device=q.device)[None, :]
        mask = kpos < valid_len
        if causal:
            mask = mask & (qpos >= kpos)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def attention_core(q, k, v, *, causal: bool, scale: Optional[float] = None,
                   impl: str = "blocked",
                   kv_len: Optional[int] = None) -> torch.Tensor:
    """Masked scaled-dot-product attention over projected q/k/v.

    ``impl="kernel"`` is the counterpart of the reference's ``"pallas"``:
    the hand-written kernel for CUDA tensors (its plain version for CPU
    ones), over ``k[:, :, :kv_len]`` when ``kv_len`` is given.
    """
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if impl == "kernel":
        if kv_len is not None:
            kv_len = int(kv_len)
            k, v = k[:, :, :kv_len], v[:, :, :kv_len]
        return kops.flash_attention(q, k, v, causal=causal, scale=scale)
    if impl == "naive":
        return _naive_core(q, k, v, causal=causal, scale=scale, kv_len=kv_len)
    if impl == "blocked":
        return _blocked_core(q, k, v, causal=causal, scale=scale,
                             kv_len=kv_len)
    if impl == "pallas":
        raise NotImplementedError("attention impl 'pallas': the port's "
                                  "kernel core is impl='kernel'")
    if impl in _LATER:
        raise NotImplementedError(f"attention impl {impl!r}: {_LATER[impl]} "
                                  "(ROADMAP, 'Modules to port')")
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def init_attn(cfg: ModelConfig, gen, dtype, device) -> nn.ParameterDict:
    """Parameters for one GQA attention block."""
    D, Hq, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = nn.ParameterDict({
        "wq": dense_init(gen, D, Hq * dh, dtype, device),
        "wk": dense_init(gen, D, Hkv * dh, dtype, device),
        "wv": dense_init(gen, D, Hkv * dh, dtype, device),
        "wo": dense_init(gen, Hq * dh, D, dtype, device),
    })
    if cfg.qkv_bias:
        for name, width in (("bq", Hq * dh), ("bk", Hkv * dh),
                            ("bv", Hkv * dh)):
            p[name] = nn.Parameter(torch.zeros((width,), dtype=dtype,
                                               device=device),
                                   requires_grad=False)
    return p


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache for incremental decoding."""
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, Hkv, max_len, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, Hkv, max_len, dh), dtype=dtype,
                         device=device),
    }


def apply_attn(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                     # (B, S, D)
    positions: torch.Tensor,             # (B, S) or (B, 3, S) for M-RoPE
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,   # tokens already cached
    impl: str = "blocked",
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One GQA attention block, optionally through the KV cache.

    The new keys and values are written in place into the preallocated
    cache at ``cache_index`` (the reference's ``dynamic_update_slice``
    returns a new array); the returned cache is the same dict.
    """
    B, S, D = x.shape
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, Hq, dh).transpose(1, 2)
    k = k.reshape(B, S, Hkv, dh).transpose(1, 2)
    v = v.reshape(B, S, Hkv, dh).transpose(1, 2)

    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)

    kv_len = None
    if cache is not None:
        start = int(cache_index)
        if start + S > cache["k"].shape[2]:
            raise ValueError(f"KV cache of {cache['k'].shape[2]} positions "
                             f"cannot take {S} tokens at {start}")
        cache["k"][:, :, start:start + S] = k.to(cache["k"].dtype)
        cache["v"][:, :, start:start + S] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        kv_len = start + S

    o = attention_core(q, k, v, causal=True, impl=impl, kv_len=kv_len)
    o = o.transpose(1, 2).reshape(B, S, Hq * dh)
    return o @ p["wo"], cache


# ---------------------------------------------------------------------------
# DeepSeek multi-head latent attention (MLA)
# ---------------------------------------------------------------------------

def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the type JAX promotes the pair to (a float32 cache read
    against bfloat16 weights is a float32 product there; PyTorch's matmul
    refuses mixed types)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype) @ b.to(dtype)


def init_mla(cfg: ModelConfig, gen, dtype, device) -> nn.ParameterDict:
    """Parameters for one multi-head latent attention block: ``wq`` (D,
    H·qd), ``w_dkv`` (D, kv_lora + rope), ``w_uk`` (kv_lora, H·nope),
    ``w_uv`` (kv_lora, H·v) and ``wo`` (H·v, D)."""
    m: MLAConfig = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return nn.ParameterDict({
        "wq": dense_init(gen, D, H * qd, dtype, device),
        "w_dkv": dense_init(gen, D, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype, device),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                           dtype, device),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype,
                           device),
        "wo": dense_init(gen, H * m.v_head_dim, D, dtype, device),
    })


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """Zeroed latent cache: ``latent`` (B, max_len, kv_lora) and ``k_rope``
    (B, max_len, rope), one per token, shared across heads."""
    m: MLAConfig = cfg.mla
    return {
        "latent": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                              device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def apply_mla(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                     # (B, S, D)
    positions: torch.Tensor,             # (B, S)
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    impl: str = "blocked",
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One MLA block, optionally through the latent cache.

    The new latents and RoPE keys are written in place at ``cache_index``;
    only the filled ``latent[:, :cache_index + S]`` is expanded to per-head
    keys and values (the reference expands all ``max_len`` positions and
    masks the tail, which adds nothing to any output)."""
    m: MLAConfig = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    qd = nope + rope

    q = (x @ p["wq"]).reshape(B, S, H, qd).transpose(1, 2)   # (B, H, S, qd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = x @ p["w_dkv"]
    latent, k_rope_flat = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    # decoupled RoPE key: one shared "head"
    k_rope = apply_rope(k_rope_flat[:, None], positions,
                        cfg.rope_theta)[:, 0]                 # (B, S, rope)

    kv_len = None
    if cache is not None:
        start = int(cache_index)
        if start + S > cache["latent"].shape[1]:
            raise ValueError(f"latent cache of {cache['latent'].shape[1]} "
                             f"positions cannot take {S} tokens at {start}")
        cache["latent"][:, start:start + S] = latent.to(
            cache["latent"].dtype)
        cache["k_rope"][:, start:start + S] = k_rope.to(cache["k_rope"].dtype)
        kv_len = start + S
        latent = cache["latent"][:, :kv_len]
        k_rope = cache["k_rope"][:, :kv_len]

    # expand the latent to per-head keys and values (non-absorbed form)
    Skv = latent.shape[1]
    k_nope = _matmul(latent, p["w_uk"]).reshape(B, Skv, H, nope) \
        .transpose(1, 2)
    vv = _matmul(latent, p["w_uv"]).reshape(B, Skv, H, m.v_head_dim) \
        .transpose(1, 2)
    k_rope_h = k_rope[:, None].expand(B, H, Skv, rope)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_h.to(k_nope.dtype)], dim=-1)
    # pad v to the q/k head dim so that one core takes it, then slice back
    if m.v_head_dim != qd:
        vv = nn.functional.pad(vv, (0, qd - m.v_head_dim))
    o = attention_core(q_full, k_full, vv, causal=True, scale=1.0 / qd ** 0.5,
                       impl=impl, kv_len=kv_len)[..., :m.v_head_dim]
    o = o.transpose(1, 2).reshape(B, S, H * m.v_head_dim)
    return o @ p["wo"], cache
