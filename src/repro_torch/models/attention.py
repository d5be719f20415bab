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

Two more cores, as in the reference: ``impl="flash_decode"``
(:func:`_flash_decode_core`), decode attention over a cache whose sequence
dim is split in chunks (over the mesh's ``model`` axis: each rank reduces
its own keys and only ``(B, H, 1, D)`` partials cross the links; an MLA
decode step expands every head over the rank's own positions of the
latent cache, :func:`mla_shard_partials`), and
``impl="kernel_proxy"`` (:func:`_kernel_proxy_core`), the costing probe's
byte model of the fused kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import MLAConfig, ModelConfig
from ..distributed.sharding import is_dtensor
from ..kernels import ops as kops
from .layers import (Params, apply_mrope, apply_rope, copy_to_model,
                     dense_init, reduce_from_model)

NEG_INF = -1e30


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


def _flash_decode_core(q, k, v, *, scale: float, kv_len=None,
                       n_chunks: Optional[int] = None) -> torch.Tensor:
    """Decode attention over a cache split in chunks along its sequence
    dim, without gathering it.

    Each chunk computes a *local* online softmax (max ``m_c``, sum
    ``l_c``, weighted values ``o_c``) over its own keys, masked with
    ``-1e30`` beyond ``kv_len``; the combine weights each chunk by ``w =
    exp(m_c - m)`` against the max ``m`` over chunks — the flash-decoding
    algorithm.  A chunk whose keys all lie beyond ``kv_len`` contributes
    ``w = 0``.

    * ``n_chunks`` given, or no ambient mesh: the chunks are reshaped
      from the cache on this device, as the reference computes them.
      ``n_chunks`` is the ambient mesh's ``model`` size when not given.
      With ``n_chunks <= 1``, ``Sq > 1``, or an S or B that does not
      divide, the blocked core runs instead, as in the reference.
    * ``k`` and ``v`` DTensors whose sequence dim (2) is sharded over
      mesh dims (the serving cache laid out by ``distributed.sharding.
      cache_shardings``): each rank's shard is its chunk, and the combine
      is one ``all_reduce(MAX)`` of ``m`` and one ``all_reduce(SUM)`` of
      ``l·w`` and ``o·w`` over those dims: only ``(B, H, 1, D)`` partials
      cross the links.  ``q`` and the output are this rank's batch rows.
    """
    if is_dtensor(k) and any(getattr(p, "dim", None) == 2
                              for p in k.placements):
        return _sharded_flash_decode(q, k, v, scale=scale, kv_len=kv_len)
    from ..distributed.axes import axis_names, axis_sizes, current_mesh
    B, Hq, Sq, D = q.shape
    _, Hkv, S, _ = k.shape
    G = Hq // Hkv
    dp_size = 1
    if n_chunks is None:
        mesh = current_mesh()
        if mesh is not None and axis_names(mesh):
            sizes = axis_sizes(mesh)
            n_chunks = sizes.get("model", 1)
            for a in ("pod", "data"):
                dp_size *= sizes.get(a, 1)
        else:
            n_chunks = 1
    # Sq > 1 needs intra-block causal masking, B=1 cells shard the seq dim
    # over the data axes instead: both defer to the blocked core
    if n_chunks <= 1 or S % n_chunks or Sq > 1 or B % dp_size:
        return _blocked_core(q, k, v, causal=True, scale=scale,
                             kv_len=kv_len)
    Sl = S // n_chunks
    kc = k.reshape(B, Hkv, n_chunks, Sl, D)
    vc = v.reshape(B, Hkv, n_chunks, Sl, D)
    qg = (q.reshape(B, Hkv, G, Sq, D) * scale).to(torch.float32)
    kpos = (torch.arange(n_chunks, device=q.device)[:, None] * Sl
            + torch.arange(Sl, device=q.device)[None, :])     # (nc, Sl)
    out = _combine_chunks(*_chunk_partials(
        qg, kc, vc, kpos, S if kv_len is None else int(kv_len)))
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _chunk_partials(qg, kc, vc, kpos, limit: int):
    """Each chunk's local online softmax: ``qg`` (B, Hkv, G, Sq, D) the
    scaled float32 queries, ``kc``/``vc`` (B, Hkv, nc, Sl, D) the chunks,
    ``kpos`` (nc, Sl) their keys' global positions, masked with ``-1e30``
    from ``limit`` on.  Returns ``(m_c, l_c, o_c)``: the max and the sum
    of exponentials (B, Hkv, G, nc, Sq) and the weighted values
    (B, Hkv, G, nc, Sq, D)."""
    s = torch.einsum("bhgqd,bhckd->bhgcqk", qg, kc.to(torch.float32))
    valid = kpos < limit
    s = torch.where(valid[None, None, None, :, None, :], s, NEG_INF)
    m_c = torch.amax(s, dim=-1)                         # (B,Hkv,G,nc,Sq)
    p = torch.exp(s - m_c[..., None])
    l_c = torch.sum(p, dim=-1)
    o_c = torch.einsum("bhgcqk,bhckd->bhgcqd", p, vc.to(torch.float32))
    return m_c, l_c, o_c


def _combine_chunks(m_c, l_c, o_c, all_max=None, all_sum=None):
    """The flash-decoding combine of :func:`_chunk_partials`' partials:
    the max ``m`` over the chunks (dim 3) and, on a mesh, over the ranks
    (``all_max``); each chunk weighted by ``w = exp(m_c - m)``; ``l·w``
    and ``o·w`` summed over the chunks and the ranks (``all_sum``, one
    reduction); ``o / l`` (B, Hkv, G, Sq, D)."""
    m = torch.amax(m_c, dim=3)                          # (B,Hkv,G,Sq)
    if all_max is not None:
        m = all_max(m)
    w = torch.exp(m_c - m[..., None, :])                # (B,Hkv,G,nc,Sq)
    lo = torch.sum(torch.cat([(l_c * w)[..., None], o_c * w[..., None]],
                             dim=-1), dim=3)
    if all_sum is not None:
        lo = all_sum(lo)
    return lo[..., 1:] / torch.clamp(lo[..., :1], min=1e-30)


def seq_shard(c, dim: int):
    """Where a DTensor cache ``c`` whose dim ``dim`` is its sequence lies:
    ``(the global position of this rank's first one, the mesh dims that
    shard it)``; the cache must be sharded on its batch (dim 0) and
    sequence dims alone."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if any(isinstance(p, Shard) and p.dim not in (0, dim)
           for p in c.placements):
        raise ValueError(f"the cache is sharded off its batch and sequence "
                         f"dims: {c.placements}")
    _shape, offset = compute_local_shape_and_global_offset(
        c.shape, c.device_mesh, c.placements)
    return offset[dim], [i for i, p in enumerate(c.placements)
                         if isinstance(p, Shard) and p.dim == dim]


def shard_partials(q, k, v, *, scale: float, offset: int, limit: int):
    """One sequence shard's flash-decoding partials, as one chunk of
    :func:`_chunk_partials`: ``q`` (B, Hq, 1, D) the step's query rows,
    ``k`` (B, Hkv, Sl, D) and ``v`` (B, Hkv, Sl, Dv) the keys and values
    at global positions ``offset ...``, masked from ``limit`` on.  A
    shard of no keys gives the neutral partial (m = -1e30, l = 0, o = 0),
    which the combine weighs at 0."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sl, Dv = v.shape
    if Sq > 1:
        raise ValueError("the sequence-sharded decode core takes one query "
                         "token a step")
    G = Hq // Hkv
    if Sl == 0:
        dev = q.device
        return (torch.full((B, Hkv, G, 1, Sq), NEG_INF, device=dev),
                torch.zeros((B, Hkv, G, 1, Sq), device=dev),
                torch.zeros((B, Hkv, G, 1, Sq, Dv), device=dev))
    qg = (q.reshape(B, Hkv, G, Sq, D) * scale).to(torch.float32)
    kpos = offset + torch.arange(Sl, device=q.device)[None, :]
    return _chunk_partials(qg, k[:, :, None], v[:, :, None], kpos, limit)


def combine_shards(parts, mesh=None, dims=()):
    """Attention output (B, Hq, 1, Dv), float32, from sequence shards'
    :func:`shard_partials`: ``parts`` this rank's, its max and sums
    all-reduced over ``mesh``'s ``dims`` (one MAX, one SUM); or the
    partials of every shard concatenated along dim 3, with no mesh."""
    from torch.distributed import _functional_collectives as funcol

    def all_reduce(x, op):
        for d in dims:
            x = funcol.wait_tensor(funcol.all_reduce(x, op, (mesh, d)))
        return x

    out = _combine_chunks(*parts, all_max=lambda m: all_reduce(m, "max"),
                          all_sum=lambda lo: all_reduce(lo, "sum"))
    B, Hkv, G, Sq, Dv = out.shape
    return out.reshape(B, Hkv * G, Sq, Dv)


def _sharded_flash_decode(q, k, v, *, scale: float, kv_len=None):
    """:func:`_flash_decode_core` on DTensor ``k``/``v`` whose sequence
    dim is sharded (see there).  ``q`` is this rank's batch rows (as the
    cache's batch dim is laid out; a DTensor is taken by its local shard)
    and so is the output."""
    if tuple(v.placements) != tuple(k.placements):
        raise ValueError(f"k {k.placements} and v {v.placements} must be "
                         "laid out alike")
    offset, dims = seq_shard(k, 2)
    ql = q.to_local() if is_dtensor(q) else q
    # this rank's shard is its one chunk
    parts = shard_partials(ql, k.to_local(), v.to_local(), scale=scale,
                           offset=offset,
                           limit=k.shape[2] if kv_len is None
                           else int(kv_len))
    return combine_shards(parts, k.device_mesh, dims).to(ql.dtype)


def write_rows(cache, rows: torch.Tensor, start: int, dim: int) -> None:
    """Write ``rows`` (this rank's batch rows) at positions ``start ...``
    of ``cache``'s dim ``dim``: in place into a plain tensor, or, for a
    DTensor sharded along ``dim``, into the part of this rank's shard
    those positions fall in."""
    n = rows.shape[dim]
    if not is_dtensor(cache):
        cache.narrow(dim, start, n).copy_(rows.to(cache.dtype))
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local = cache.to_local()
    lshape, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    lo = max(start, offset[dim])
    hi = min(start + n, offset[dim] + lshape[dim])
    if hi > lo:
        local.narrow(dim, lo - offset[dim], hi - lo).copy_(
            rows.narrow(dim, lo - start, hi - lo).to(local.dtype))


def _kernel_proxy_core(q, k, v, *, scale: float, kv_len=None) -> torch.Tensor:
    """HBM-traffic model of the fused flash kernel, for the bytes costing
    probe ONLY: reads q, k, v once and writes one q-shaped output — the S²
    score/softmax arithmetic stays on chip and never round-trips.  (FLOPs
    come from the separate naive probe; this core's arithmetic is a
    placeholder with the right data movement, not the right math.)"""
    B, Hq, Sq, D = q.shape
    _, Hkv, _, _ = k.shape
    o = (q.reshape(B, Hkv, Hq // Hkv, Sq, D)
         + torch.mean(k.to(torch.float32), dim=2)[:, :, None, None, :]
         .to(q.dtype)
         + torch.mean(v.to(torch.float32), dim=2)[:, :, None, None, :]
         .to(q.dtype))
    return o.reshape(B, Hq, Sq, D) * scale


def attention_core(q, k, v, *, causal: bool, scale: Optional[float] = None,
                   impl: str = "blocked", kv_len: Optional[int] = None,
                   n_chunks: Optional[int] = None) -> torch.Tensor:
    """Masked scaled-dot-product attention over projected q/k/v.

    ``impl="kernel"`` is the counterpart of the reference's ``"pallas"``:
    the hand-written kernel for CUDA tensors (its plain version for CPU
    ones), over ``k[:, :, :kv_len]`` when ``kv_len`` is given.
    ``n_chunks`` is ``impl="flash_decode"``'s (see
    :func:`_flash_decode_core`).
    """
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if impl == "kernel_proxy":
        return _kernel_proxy_core(q, k, v, scale=scale, kv_len=kv_len)
    if impl == "flash_decode":
        return _flash_decode_core(q, k, v, scale=scale, kv_len=kv_len,
                                  n_chunks=n_chunks)
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
    returns a new array); the returned cache is the same dict.  On a mesh
    a serving prefill's rank holds its Hq/m and Hkv/m heads: ``p``'s
    ``wq``/``wk``/``wv`` columns and ``wo`` rows of them, and ``cache``
    plain tensors of its Hkv/m heads over the whole sequence
    (``sharding.kv_heads_local``); its output is a partial sum that
    ``reduce_from_model`` completes.  A decode step holds every head, its
    cache a DTensor where the sequence is sharded (``flash_decode``).
    """
    B, S, D = x.shape
    dh = cfg.head_dim
    # under a mesh wq/wk/wv (and wo's rows) may be this rank's model shard
    # of whole heads (distributed.sharding.gather_for_compute)
    Hq, Hkv = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    x = copy_to_model(x, Hq, cfg.n_heads)
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
        write_rows(cache["k"], k, start, 2)
        write_rows(cache["v"], v, start, 2)
        k, v = cache["k"], cache["v"]
        kv_len = start + S

    o = attention_core(q, k, v, causal=True, impl=impl, kv_len=kv_len)
    o = o.transpose(1, 2).reshape(B, S, Hq * dh)
    return reduce_from_model(o @ p["wo"], Hq, cfg.n_heads), cache


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


def mla_project(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor):
    """An MLA block's projections of ``x`` (B, S, D): the queries (B, H,
    S, qd) of the heads ``wq`` holds, RoPE applied to their last
    ``qk_rope_head_dim`` columns, and the new latents (B, S, kv_lora) and
    shared RoPE keys (B, S, rope)."""
    m: MLAConfig = cfg.mla
    B, S, D = x.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    qd = nope + rope
    H = p["wq"].shape[-1] // qd

    q = (copy_to_model(x, H, cfg.n_heads) @ p["wq"]) \
        .reshape(B, S, H, qd).transpose(1, 2)                # (B, H, S, qd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    # w_dkv is whole on every rank, but its latent and RoPE key feed this
    # rank's heads alone: their gradient is summed over the model group
    dkv = copy_to_model(x @ p["w_dkv"], H, cfg.n_heads)
    latent, k_rope_flat = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    # decoupled RoPE key: one shared "head"
    k_rope = apply_rope(k_rope_flat[:, None], positions,
                        cfg.rope_theta)[:, 0]                 # (B, S, rope)
    return torch.cat([q_nope, q_rope], dim=-1), latent, k_rope


def _mla_expand(cfg: ModelConfig, p: Params, latent: torch.Tensor,
                k_rope: torch.Tensor, H: int):
    """Per-head keys (B, H, L, qd) and values (B, H, L, v) of ``H`` heads
    from L positions of the latent (B, L, kv_lora) and RoPE keys (B, L,
    rope): the non-absorbed form."""
    m: MLAConfig = cfg.mla
    B, L = latent.shape[:2]
    nope = m.qk_nope_head_dim
    k_nope = _matmul(latent, p["w_uk"]).reshape(B, L, H, nope) \
        .transpose(1, 2)
    vv = _matmul(latent, p["w_uv"]).reshape(B, L, H, m.v_head_dim) \
        .transpose(1, 2)
    k_rope_h = k_rope[:, None].expand(B, H, L, m.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_h.to(k_nope.dtype)], dim=-1), vv


def mla_shard_partials(cfg: ModelConfig, p: Params, q: torch.Tensor,
                       latent: torch.Tensor, k_rope: torch.Tensor, *,
                       offset: int, kv_len: int):
    """A decode step's flash-decoding partials (:func:`shard_partials`)
    over one sequence shard of the latent cache: ``latent`` (B, Sl,
    kv_lora) and ``k_rope`` (B, Sl, rope) hold global positions ``offset
    ...``; every head of ``q`` (B, H, 1, qd) is expanded over the shard's
    positions below ``kv_len`` alone (none where the shard starts at or
    beyond it)."""
    m: MLAConfig = cfg.mla
    n = max(0, min(latent.shape[1], kv_len - offset))
    k, v = _mla_expand(cfg, p, latent[:, :n], k_rope[:, :n], q.shape[1])
    return shard_partials(
        q, k, v, scale=1.0 / (m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5,
        offset=offset, limit=kv_len)


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
    masks the tail, which adds nothing to any output).

    Under a mesh ``wq``, ``w_uk`` and ``w_uv``'s columns and ``wo``'s rows
    may be this rank's ``model`` shard of whole heads
    (``distributed.sharding.gather_for_compute``): H is read from ``wq``'s
    width, the rank computes its H/m heads from the whole latent and one
    ``reduce_from_model`` sums ``o @ wo``.  Without a model group the
    partial output of those heads is returned.

    A decode step (S = 1, ``impl="flash_decode"``) whose ``latent`` and
    ``k_rope`` are DTensors sharded on their sequence (dim 1), as
    ``cache_shardings`` lays them out, reads them where they lie, as the
    reference's flash-decode core compiles: the new token goes into the
    one shard that holds its position, each rank expands every head over
    its own filled positions (:func:`mla_shard_partials`), and the
    partials are combined over the sequence's mesh dims
    (:func:`combine_shards`)."""
    m: MLAConfig = cfg.mla
    B, S, D = x.shape
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    q, latent, k_rope = mla_project(cfg, p, x, positions)
    H = q.shape[1]

    if cache is not None and is_dtensor(cache["latent"]):
        if S != 1 or impl != "flash_decode":
            raise ValueError(f"a sequence-sharded latent cache is read by a "
                             f"flash_decode step of one token, not {S} "
                             f"tokens on {impl!r}")
        start = int(cache_index)
        write_rows(cache["latent"], latent, start, 1)
        write_rows(cache["k_rope"], k_rope, start, 1)
        offset, dims = seq_shard(cache["latent"], 1)
        parts = mla_shard_partials(cfg, p, q, cache["latent"].to_local(),
                                   cache["k_rope"].to_local(), offset=offset,
                                   kv_len=start + 1)
        o = combine_shards(parts, cache["latent"].device_mesh,
                           dims).to(q.dtype)
    else:
        kv_len = None
        if cache is not None:
            start = int(cache_index)
            if start + S > cache["latent"].shape[1]:
                raise ValueError(f"latent cache of "
                                 f"{cache['latent'].shape[1]} positions "
                                 f"cannot take {S} tokens at {start}")
            cache["latent"][:, start:start + S] = latent.to(
                cache["latent"].dtype)
            cache["k_rope"][:, start:start + S] = k_rope.to(
                cache["k_rope"].dtype)
            kv_len = start + S
            latent = cache["latent"][:, :kv_len]
            k_rope = cache["k_rope"][:, :kv_len]
        k, vv = _mla_expand(cfg, p, latent, k_rope, H)
        # pad v to the q/k head dim so that one core takes it, then slice
        # back
        if m.v_head_dim != qd:
            vv = nn.functional.pad(vv, (0, qd - m.v_head_dim))
        o = attention_core(q, k, vv, causal=True, scale=1.0 / qd ** 0.5,
                           impl=impl, kv_len=kv_len)[..., :m.v_head_dim]
    o = o.transpose(1, 2).reshape(B, S, H * m.v_head_dim)
    return reduce_from_model(o @ p["wo"], H, cfg.n_heads), cache
