"""Plain PyTorch versions of the hand-written kernels.

These follow the reference package's oracles (``repro/kernels/ref.py``)
line by line and are the semantics of record for the CUDA kernels: on the
card ``chip_smoke.py`` holds each kernel against its plain version, and on
the CPU they are the execution path (``ops`` dispatches here for CPU
tensors).  Both take and return tensors on any device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

GRID_UPDATE_OPS = ("set", "add", "max")


def qvp_reduce(
    field: torch.Tensor,                   # (time, azimuth, range)
    quality: Optional[torch.Tensor] = None,  # same shape, e.g. RHOHV
    *,
    quality_min: float = 0.85,
    min_valid_fraction: float = 0.1,
) -> torch.Tensor:
    """Azimuthal mean with NaN + quality masking -> (time, range).

    A gate contributes when it is finite and its quality metric passes
    ``quality_min``.  Rows (time, range) with fewer than
    ``min_valid_fraction`` valid azimuths are NaN (Ryzhkov et al. 2016).
    """
    valid = torch.isfinite(field)
    if quality is not None:
        valid &= torch.isfinite(quality) & (quality >= quality_min)
    x = torch.where(valid, field, 0.0).to(torch.float32)
    count = valid.sum(dim=1).to(torch.float32)
    total = x.sum(dim=1)
    n_az = field.shape[1]
    mean = total / torch.clamp(count, min=1.0)
    # the threshold is compared as a float32, as the reference's weakly
    # typed Python scalar is
    threshold = float(np.float32(min_valid_fraction * n_az))
    return torch.where(count >= threshold, mean, float("nan"))


def _take_columns(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[:, idx]`` with ``jnp.take``'s default (fill) semantics, which
    the reference oracles have: a negative index counts from the end once,
    and an index still outside ``[0, n)`` reads as NaN."""
    n = x.shape[1]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    if n == 0:
        return torch.full((x.shape[0], *idx.shape), float("nan"),
                          dtype=x.dtype, device=x.device)
    vals = x[:, torch.where(inside, idx, 0)]
    return torch.where(inside, vals, float("nan"))


def live_slots(
    gate_idx: torch.Tensor,         # (..., k) integer flat gate indices
    weights: torch.Tensor,          # same shape, float32
    n_gates: int,
) -> torch.Tensor:
    """The slots that can add to a mean, whatever the field holds: weight
    > 0 and, after ``jnp.take``'s index rule, a gate in ``[0, n_gates)``."""
    idx = gate_idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n_gates, idx)
    return (weights > 0.0) & (idx >= 0) & (idx < n_gates)


def _grid_map_sweep(
    field: torch.Tensor,            # (time, gates): flattened (az, range)
    gate_idx: torch.Tensor,         # (cells, k) integer flat gate indices
    weights: torch.Tensor,          # (cells, k) float32, <= 0 means "no gate"
) -> torch.Tensor:
    f = field.to(torch.float32)
    w = weights.to(torch.float32)
    T, C, k = f.shape[0], gate_idx.shape[0], gate_idx.shape[1]
    vals = _take_columns(f, gate_idx.reshape(-1)).reshape(T, C, k)
    valid = torch.isfinite(vals) & (w > 0.0)[None, :, :]
    wv = torch.where(valid, w[None, :, :], 0.0)
    x = torch.where(valid, vals, 0.0)
    num = torch.zeros((T, C), dtype=torch.float32, device=f.device)
    den = torch.zeros((T, C), dtype=torch.float32, device=f.device)
    for j in range(k):
        num = num + x[:, :, j] * wv[:, :, j]
        den = den + wv[:, :, j]
    return torch.where(den > 0.0, num / torch.clamp(den, min=1e-12),
                       float("nan"))


def grid_map(
    field,                          # (time, gates) tensor, or S of them
    gate_idx: torch.Tensor,         # (cells, k) or (cells, S, k) integer
    weights: torch.Tensor,          # the same shape, float32
    *,
    order=None,                     # a kernels.grid_map.CellOrder
) -> torch.Tensor:
    """Masked weighted gather: polar gates -> Cartesian cells, (time, cells),
    over S sweeps folded by a NaN-aware max.

    For each sweep, a map row's value is the weight-normalized mean of its
    (at most) k contributing gates, skipping non-finite gate values and
    non-positive weights, NaN with no valid contribution.  The sums are a
    left fold over j = 0 .. k-1 from +0.0, each product and each sum
    rounded on its own: the order (and the rounding) the CUDA kernel uses,
    and bitwise what the reference oracle gives.  With a (cells, S, k) map
    and S fields, the sweeps' values fold left by ``torch.fmax`` (NaN only
    where every sweep is NaN), as the reference's column-max does with
    ``np.fmax.reduce``.  With ``order``, row i lands in column
    ``order.cells[i]`` (a permutation, checked when the order was made),
    and ``order.n_live`` promises that rows from it on have no live slot
    (:func:`live_slots`): the kernel writes them NaN without loading them.
    Raises ``ValueError`` on an order of another length or a broken
    promise, which the kernel would trust.
    """
    fields = [field] if isinstance(field, torch.Tensor) else list(field)
    idx, w = gate_idx, weights
    if idx.dim() == 2:
        idx, w = idx[:, None, :], w[:, None, :]
    C, S = idx.shape[0], idx.shape[1]
    if len(fields) != S or S == 0:
        raise ValueError(f"grid_map: {len(fields)} fields for a map of "
                         f"{S} sweeps")
    out = None
    for s, f in enumerate(fields):
        mean = _grid_map_sweep(f, idx[:, s], w[:, s])
        out = mean if out is None else torch.fmax(out, mean)
    if order is None:
        return out
    if order.cells.numel() != C:
        raise ValueError(f"grid_map: an order of {order.cells.numel()} "
                         f"cells for {C} map rows")
    live = live_slots(idx, w, fields[0].shape[1]).reshape(C, -1)
    if bool(live[order.n_live:].any()):
        raise ValueError(f"grid_map: rows from n_live={order.n_live} on "
                         "must have no live slot")
    placed = torch.empty_like(out)
    placed[:, order.cells.to(device=out.device, dtype=torch.int64)] = out
    return placed


def grid_update(
    state: torch.Tensor,            # (time, cells) current product state
    upd: torch.Tensor,              # (time, touched) freshly computed values
    pos: torch.Tensor,              # (cells,) integer: column of upd, < 0 = keep
    *,
    op: str = "set",
) -> torch.Tensor:
    """Patch only the touched cells of a gridded product, (time, cells).

    ``pos`` maps every cell to its column in the compact update block
    (negative for cells that keep their state bitwise).  ``op`` combines a
    touched cell with its update: ``"set"`` replaces, ``"add"``
    accumulates, ``"max"`` is the NaN-aware maximum (``torch.fmax``).  A
    column ``pos >= M`` reads as NaN, as in the reference oracle.  With
    ``upd`` empty along cells the state is returned unchanged.
    """
    if op not in GRID_UPDATE_OPS:
        raise ValueError(f"unknown grid_update op {op!r} (set|add|max)")
    s = state.to(torch.float32)
    if upd.shape[1] == 0 or s.shape[0] == 0 or s.shape[1] == 0:
        return s
    u = upd.to(torch.float32)
    p = pos.to(torch.int64)
    touched = p >= 0
    vals = _take_columns(u, torch.where(touched, p, 0))
    if op == "set":
        new = vals
    elif op == "add":
        new = s + vals
    else:
        new = torch.fmax(s, vals)
    return torch.where(touched[None, :], new, s)


def grid_scatter_(
    state: torch.Tensor,            # (time, cells) float32, patched in place
    upd: torch.Tensor,              # (time, M) values of the touched cells
    cells: torch.Tensor,            # (M,) integer, strictly increasing
    *,
    op: str = "set",
) -> torch.Tensor:
    """Patch the touched cells of ``state`` in place and return it:
    ``state[:, cells[j]] = state[:, cells[j]] (op) upd[:, j]``.

    The plain version of the CUDA kernel (``csrc/grid_update.cu``,
    ``grid_scatter_launch``), bitwise what
    :func:`grid_update` gives with ``pos[cells[j]] = j`` (-1 elsewhere).
    ``cells`` must be strictly increasing and in ``[0, C)``: raises
    ``ValueError`` otherwise (the kernel does not check; every cell is
    written once there, so no two updates may share one).
    """
    if op not in GRID_UPDATE_OPS:
        raise ValueError(f"unknown grid_update op {op!r} (set|add|max)")
    if state.dtype != torch.float32 or state.dim() != 2:
        raise TypeError("grid_scatter_: state must be a (T, C) float32 "
                        f"tensor, got {state.dtype} {tuple(state.shape)}")
    T, C = state.shape
    if upd.dim() != 2 or cells.dim() != 1 or upd.shape[0] != T \
            or upd.shape[1] != cells.shape[0]:
        raise ValueError("grid_scatter_: need upd (T, M) and cells (M,), "
                         f"got {tuple(upd.shape)} and {tuple(cells.shape)} "
                         f"for state {tuple(state.shape)}")
    if cells.numel() == 0:
        return state
    c = cells.to(torch.int64)
    if int(c[0]) < 0 or int(c[-1]) >= C or bool((c[1:] <= c[:-1]).any()):
        raise ValueError("grid_scatter_: cells must be strictly increasing "
                         f"and in [0, {C})")
    if T == 0:
        return state
    u = upd.to(torch.float32)
    if op == "set":
        state[:, c] = u
    elif op == "add":
        state[:, c] = state[:, c] + u
    else:
        state[:, c] = torch.fmax(state[:, c], u)
    return state


def zr_accum(
    dbz: torch.Tensor,              # (time, azimuth, range)
    dt_s: torch.Tensor,             # (time,) integration weight per scan, s
    *,
    a: float = 200.0,
    b: float = 1.6,
    dbz_min: float = 5.0,
    dbz_max: float = 53.0,          # hail cap, standard practice
) -> torch.Tensor:
    """Accumulated precipitation in mm -> (azimuth, range).

    R = (10^(dBZ/10) / a)^(1/b)  [mm/h];  accum = sum_t R_t * dt_t / 3600.
    """
    dbz_c = torch.clamp(dbz, dbz_min, dbz_max)
    z_lin = torch.pow(10.0, dbz_c / 10.0)
    rate = torch.pow(z_lin / a, 1.0 / b)                    # mm/h
    rate = torch.where(torch.isfinite(dbz) & (dbz >= dbz_min), rate, 0.0)
    w = (dt_s / 3600.0).to(torch.float32)[:, None, None]
    return torch.sum(rate * w, dim=0).to(torch.float32)


def zr_exp2_constants(a: float, b: float) -> Tuple[float, float]:
    """The float32 constants of the one-exponential rate,
    ``R = 2 ** (dc * k1 - k0)``: ``k1 = (1/b) log2(10) / 10`` and
    ``k0 = (1/b) log2(a)``, formed in float64 from ``1/b`` and ``a`` as
    float32 (the reference's weakly typed scalars are) and each rounded
    once to float32."""
    if not a > 0:
        raise ValueError(f"zr_accum: need a > 0, got {a}")
    inv_b = float(np.float32(1.0 / b))
    k1 = float(np.float32(inv_b * math.log2(10.0) / 10.0))
    k0 = float(np.float32(inv_b * math.log2(float(np.float32(a)))))
    return k1, k0


def zr_accum_exp2(
    dbz: torch.Tensor,              # (time, azimuth, range)
    dt_s: torch.Tensor,             # (time,) integration weight per scan, s
    *,
    a: float = 200.0,
    b: float = 1.6,
    dbz_min: float = 5.0,
    dbz_max: float = 53.0,
) -> torch.Tensor:
    """The CUDA kernel's formula in torch float32 -> (azimuth, range) mm.

    :func:`zr_accum`'s function with the rate as one exponential,
    ``R = 2 ** (dc * k1 - k0)`` (:func:`zr_exp2_constants`), the weights
    ``dt / 3600`` and the sum a left fold over time with each product and
    each sum rounded on its own, as ``csrc/zr_accum.cu`` computes it.  The
    kernel's ``fmaf`` is emulated by one rounding of the exact float64
    product-difference, and its ``exp2f`` (2 ulp) by ``torch.exp2``, so
    the two agree to a few float32 ulps, not bit for bit.
    """
    k1, k0 = zr_exp2_constants(a, b)
    d = dbz.to(torch.float32)
    dc = torch.clamp(d, dbz_min, dbz_max)
    arg = (dc.to(torch.float64) * k1 - k0).to(torch.float32)
    rate = torch.where(torch.isfinite(d) & (d >= dbz_min), torch.exp2(arg),
                       0.0)
    w = dt_s.to(torch.float32) / 3600.0
    acc = torch.zeros(d.shape[1:], dtype=torch.float32, device=d.device)
    for t in range(d.shape[0]):
        acc = acc + rate[t] * w[t]
    return acc


def flash_attention(
    q: torch.Tensor,            # (B, Hq, Sq, D)
    k: torch.Tensor,            # (B, Hkv, Skv, D)
    v: torch.Tensor,            # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention with GQA head grouping.

    For decode (Sq < Skv) the query block is aligned to the *end* of the
    key sequence, i.e. query i attends to keys <= Skv - Sq + i.
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum(
        "bhqd,bhkd->bhqk", q.to(torch.float32), kk.to(torch.float32)
    ) * scale
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv.to(torch.float32))
    return out.to(q.dtype)


def flash_decode(
    q: torch.Tensor,            # (B, Hq, 1, D)
    k: torch.Tensor,            # (B, Hkv, Skv, D)
    v: torch.Tensor,            # (B, Hkv, Skv, D)
    n_split: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Split-key decode attention, the plain version of the decode kernel
    (``csrc/flash_decode.cu``): one query sees every key.  The keys fall
    into ``n_split`` runs of ``ceil(Skv / n_split)`` (the last one ragged,
    possibly empty); each run gives its max ``m``, sum ``l`` and weighted
    values ``o`` in float32, and the runs merge in order as the
    reference's ``_flash_decode_core`` combines its chunks:
    ``out = sum(o_s w_s) / max(sum(l_s w_s), 1e-30)``,
    ``w_s = exp(m_s - max m)``.
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if Sq != 1:
        raise ValueError(f"flash_decode: one query per head, got Sq={Sq}")
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    chunk = -(-Skv // n_split)
    qg = q.reshape(B, Hkv, G, D).to(torch.float32)
    ms, ls, os_ = [], [], []
    for s in range(n_split):
        kj = k[:, :, s * chunk:(s + 1) * chunk].to(torch.float32)
        vj = v[:, :, s * chunk:(s + 1) * chunk].to(torch.float32)
        sc = torch.einsum("bhgd,bhkd->bhgk", qg, kj) * scale
        m = (torch.amax(sc, dim=-1) if kj.shape[2]
             else torch.full((B, Hkv, G), -1e30, device=q.device))
        p = torch.exp(sc - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bhgk,bhkd->bhgd", p, vj))
    m_all = torch.stack(ms).amax(dim=0)
    l_all = torch.zeros_like(m_all)
    o_all = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for m, l, o in zip(ms, ls, os_):
        w = torch.exp(m - m_all)
        l_all = l_all + l * w
        o_all = o_all + o * w[..., None]
    out = o_all / torch.clamp(l_all, min=1e-30)[..., None]
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def mamba2_scan(
    x: torch.Tensor,            # (B, L, H, P)
    dt: torch.Tensor,           # (B, L, H)   positive (already softplus'd)
    A: torch.Tensor,            # (H,)        negative
    Bmat: torch.Tensor,         # (B, L, N)   input projection (ngroups=1)
    Cmat: torch.Tensor,         # (B, L, N)   output projection
    *,
    h0: Optional[torch.Tensor] = None,   # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential oracle for the Mamba2/SSD recurrence.

        h_t = exp(A * dt_t) * h_{t-1} + dt_t * x_t  B_t^T
        y_t = h_t C_t + 0  (skip connection handled by the caller)

    Returns (y (B, L, H, P) in x's dtype, final state (B, H, P, N) in
    float32).  A Python loop over L stands in for the reference's
    ``lax.scan``.
    """
    Bsz, L, H, P = x.shape
    N = Bmat.shape[-1]
    if h0 is None:
        h0 = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    xf = x.to(torch.float32)
    dtf = dt.to(torch.float32)
    Bf = Bmat.to(torch.float32)
    Cf = Cmat.to(torch.float32)
    Af = A.to(torch.float32)
    h = h0.to(torch.float32)
    ys = []
    for t in range(L):
        x_t, dt_t, b_t, c_t = xf[:, t], dtf[:, t], Bf[:, t], Cf[:, t]
        decay = torch.exp(Af[None, :] * dt_t)                 # (B, H)
        upd = (dt_t[..., None] * x_t)[..., None] * b_t[:, None, None, :]
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, c_t))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((Bsz, 0, H, P), dtype=torch.float32,
                          device=x.device))
    return y.to(x.dtype), h


def _bf16_pair(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``v`` (float32) as the two bf16 halves the tensor cores take, back
    in float32: ``hi = bf16(v)``, ``lo = bf16(v - hi)``."""
    hi = v.to(torch.bfloat16).to(torch.float32)
    return hi, (v - hi).to(torch.bfloat16).to(torch.float32)


def _pair(v: torch.Tensor, terms: int, parts: int = 2):
    """``v`` as the kernels send it to the tensor cores, back in float32:
    ``(hi, lo)``, with ``lo`` None where the tensor is exact in bf16 (a
    bf16 input) or ``terms == 1`` (hi alone); with ``parts=3`` the three
    bf16 parts ``(hi, mid, lo)``, ``mid = bf16(v - hi)``, ``lo = bf16(v -
    hi - mid)``."""
    if v.dtype == torch.bfloat16:
        return v.to(torch.float32), None
    hi, lo = _bf16_pair(v.to(torch.float32))
    if terms == 1:
        return hi, None
    if parts == 3:
        mid, lo = _bf16_pair(v.to(torch.float32) - hi)
        return hi, mid, lo
    return hi, lo


def _products(eq: str, a, b):
    """The bf16 products of two split operands in the kernels' order, each
    an einsum in float32: part i of ``a`` with part j of ``b`` where i + j
    is at most the number of parts less one (pairs: hi.hi, hi.lo, lo.hi,
    lo.lo dropped; triples: the six products down to 2^-18 of the
    product), by i + j, then by j from the largest; a missing part adds no
    term."""
    order = max(len(a), len(b)) - 1
    out = []
    for k in range(order + 1):
        for j in range(k, -1, -1):
            i = k - j
            if (i < len(a) and j < len(b) and a[i] is not None
                    and b[j] is not None):
                out.append(torch.einsum(eq, a[i], b[j]))
    return out


def _fold(first: torch.Tensor, rest) -> torch.Tensor:
    """``first + rest[0] + rest[1] + ...``, left to right in float32."""
    for t in rest:
        first = first + t
    return first


def _sum(xs) -> torch.Tensor:
    """``xs[0] + xs[1] + ...``, left to right."""
    return _fold(xs[0], xs[1:])


def _rows(pair, sl: slice, dim: int):
    """Every part of a split operand sliced along ``dim``."""
    return tuple(None if t is None else t.narrow(dim, sl.start,
                                                  sl.stop - sl.start)
                 for t in pair)


def _check_terms(terms: int) -> None:
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 (hi.hi) or 3 (hi.hi + hi.lo + "
                         f"lo.hi), got {terms}")


def flash_attention_pairs(
    q: torch.Tensor,            # (B, Hq, Sq, D) float32
    k: torch.Tensor,            # (B, Hkv, Skv, D) float32
    v: torch.Tensor,            # (B, Hkv, Skv, D) float32
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    terms: int = 3,
) -> torch.Tensor:
    """The float32 prefill kernel's arithmetic (``csrc/flash_attention.cu``,
    route ``f32``), its plain version -> (B, Hq, Sq, D) float32.

    Each float32 operand of the tensor cores goes as a bf16 pair, ``hi =
    bf16(v)``, ``lo = bf16(v - hi)``, and each product as three bf16
    products summed in float32, lo.lo dropped: per key tile of 64 keys
    (the kernel's), ``S = Qh Kh^T + Qh Kl^T + Ql Kh^T``, scaled, masked to -1e30
    (causal aligned to the end of the keys, keys past Skv), an online
    softmax in float32 (running max m, sum l of the float32 weights),
    then ``O = alpha O + Ph Vh + Ph Vl + Pl Vh``; the output
    ``O / max(l, 1e-30)``.  ``terms=1`` keeps hi.hi alone, the form whose
    error the 2e-4 float32 tolerance must see.
    """
    _check_terms(terms)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    dev = q.device
    qp = _pair(q.to(torch.float32), terms)
    kp = _pair(torch.repeat_interleave(k.to(torch.float32), group, 1), terms)
    vp = _pair(torch.repeat_interleave(v.to(torch.float32), group, 1), terms)
    rows = torch.arange(Sq, device=dev)[:, None] + (Skv - Sq)
    m = torch.full((B, Hq, Sq, 1), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hq, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=dev)
    # every tile for every row: a tile a row cannot see gives it p = 0 and
    # alpha = 1, which leave m, l and O as they were (the kernel stops early)
    for k0 in range(0, Skv, 64):
        sl = slice(k0, min(k0 + 64, Skv))
        s = _sum(_products("bhqd,bhkd->bhqk", qp, _rows(kp, sl, 2))) * scale
        if causal:
            cols = torch.arange(sl.start, sl.stop, device=dev)[None, :]
            s = torch.where(rows >= cols, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = _fold(acc * alpha, _products("bhqk,bhkd->bhqd", _pair(p, terms),
                                           _rows(vp, sl, 2)))
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


def mamba2_scan_chunks(
    x: torch.Tensor,            # (B, L, H, P) bfloat16 or float32
    dt: torch.Tensor,           # (B, L, H)
    A: torch.Tensor,            # (H,)
    Bmat: torch.Tensor,         # (B, L, N) x's dtype
    Cmat: torch.Tensor,         # (B, L, N) x's dtype
    *,
    h0: Optional[torch.Tensor] = None,   # (B, H, P, N)
    chunk: int = 64,
    terms: int = 3,
    parts: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked form with the operand roundings of the tensor-core
    kernels (``csrc/mamba2_scan.cu``: ``chunk_tc`` for bf16, the ``f32``
    route's kernel for float32, the wide routes' kernel, with ``parts=3``
    for float32), their plain version.  Per chunk of
    ``chunk`` tokens, L_t the cumulative sum of A dt_u:

        S   = C B^T
        y   = exp(L_t) C h^T + (M o S) x,   M[t, s] = exp(L_t - L_s) dt_s, s <= t
        h  <- exp(L_last) h + ((w o B)^T x)^T,  w_s = exp(L_last - L_s) dt_s

    Every operand of the tensor cores goes as a bf16 pair, ``hi =
    bf16(v)``, ``lo = bf16(v - hi)``, and every product as the bf16
    products hi.hi, hi.lo and lo.hi summed in float32 in that order (lo.lo
    dropped).  bf16 x, B and C are exact in bf16 (no lo), so a product
    with them is two bf16 products; float32 ones are split too, and w o B
    is formed from B's pair, ``w (Bh + Bl)`` (the kernel keeps only the
    pair in shared memory).  h, M o S and w o B are computed in float32
    and split.  ``terms=1`` keeps hi.hi alone, the form whose error the
    float32 tolerance must see.  ``parts=3`` splits the float32 operands
    of the two products summed over N, S = C B^T and C h^T, and of y's
    (M o S) x (M o S grows with N) into three bf16 parts (hi, mid, lo) and
    takes their six products down to 2^-18 of the product (hi.hi; hi.mid,
    mid.hi; hi.lo, mid.mid, lo.hi), since a pair's 16 bits miss the
    float32 tolerance in sums over N of a few hundred terms; w o B is then
    formed from B's three parts, and the state update takes the pairs of
    w o B and x (x's first two parts).  Returns (y in x's dtype, the final
    state float32), the function of :func:`mamba2_scan`.
    """
    _check_terms(terms)
    if parts not in (2, 3):
        raise ValueError(f"parts must be 2 or 3, got {parts}")
    Bsz, L, H, P = x.shape
    N = Bmat.shape[-1]
    dev = x.device
    xp, bp, cp = (_pair(t, terms, parts) for t in (x, Bmat, Cmat))
    dtf, Af = dt.to(torch.float32), A.to(torch.float32)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
         if h0 is None else h0.to(torch.float32))

    ys = []
    for t0 in range(0, L, chunk):
        sl = slice(t0, min(t0 + chunk, L))
        xc, bc, cc = (_rows(t, sl, 1) for t in (xp, bp, cp))
        lc = torch.cumsum(Af[None, None, :] * dtf[:, t0:t0 + chunk], dim=1)
        dc = dtf[:, t0:t0 + chunk]                          # (B, c, H)
        c = xc[0].shape[1]
        s_cb = _sum(_products("btn,bsn->bts", cc, bc))
        seg = lc[:, :, None, :] - lc[:, None, :, :]          # (B, t, s, H)
        tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
        m = torch.where(tril[None, :, :, None],
                        torch.exp(torch.where(tril[None, :, :, None], seg,
                                              0.0)) * dc[:, None, :, :],
                        0.0)
        ms = _pair(m * s_cb[..., None], terms, parts)        # (B, t, s, H)
        z = _sum(_products("btn,bhpn->bthp", cc, _pair(h, terms, parts)))
        y = _fold(torch.exp(lc)[..., None] * z,
                  _products("btsh,bshp->bthp", ms, xc))
        ys.append(y)
        l_last = lc[:, -1]                                   # (B, H)
        w = torch.exp(l_last[:, None, :] - lc) * dc          # (B, s, H)
        b_eff = _sum([t for t in bc if t is not None])
        wb = _pair(w[..., None] * b_eff[:, :, None, :], terms)
        h = _fold(torch.exp(l_last)[..., None, None] * h,
                  _products("bshn,bshp->bhpn", wb, xc[:2]))
    y = (torch.cat(ys, dim=1) if ys
         else torch.zeros((Bsz, 0, H, P), dtype=torch.float32, device=dev))
    return y.to(x.dtype), h
