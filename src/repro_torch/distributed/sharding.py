"""Sharding rules: params (TP + FSDP), batches, and serving caches.

The port of the reference package's ``distributed/sharding.py``.  The
rules are *structural*, driven by leaf name + shape + divisibility:

* **TP** on the ``"model"`` axis — column-parallel on up-projections /
  QKV / unembedding, row-parallel on down-/out-projections, expert-parallel
  on MoE expert tensors, vocab-parallel on embeddings.
* **FSDP** over ``("pod", "data")`` — the largest *remaining* weight dim
  (never the stacked-layers dim).
* Anything not divisible by the axis size stays replicated on that axis —
  the rules never produce padded shards.

A *spec* is the reference's ``PartitionSpec`` as a plain tuple, one entry
per tensor dim: ``None``, an axis name, or a tuple of axis names (the
reference's own, so tests compare them entry by entry).  The rule
functions take a ``DeviceMesh`` or a device-less
:class:`~repro_torch.distributed.axes.AbstractMesh` and return a tree of specs
shaped like their input; :func:`placements` turns one spec into DTensor
placements on a mesh, and :func:`distribute` lays a tree of tensors out
as DTensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ParallelConfig
from .axes import (abstract_mesh, axis_names, axis_sizes, current_mesh,
                   fsdp_axes)

Spec = Tuple[Any, ...]

# leaf name -> which *logical* dim (negative index) tensor-parallelizes
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "shared_gate", "shared_up",
        "w_uk", "w_uv", "w_in", "w_x", "w_up_gate", "w_gates", "head",
        "w_dkv", "concat_proj"}
_ROW = {"wo", "w_down", "shared_down"}
_BIAS_COL = {"bq", "bk", "bv", "b_up"}
_HEAD_LEADING = {"w_q", "w_k", "w_v", "r_h"}   # (H, dh, ·) mlstm per-head
_MOE_EXPERT = {"w_gate", "w_up", "w_down"}


def _divides(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _leaf_spec(
    key: str,
    shape: Tuple[int, ...],
    *,
    n_stack: int,
    is_moe_ffn: bool,
    mesh,
    fsdp_axes: Tuple[str, ...],
    fsdp_params: bool,
) -> Spec:
    spec: list = [None] * len(shape)
    sizes = axis_sizes(mesh)
    model_size = sizes.get("model", 1)
    fsdp_size = 1
    for a in fsdp_axes:
        fsdp_size *= sizes[a]
    nd = len(shape) - n_stack          # logical (unstacked) ndim

    def logical(dim_neg: int) -> int:  # negative logical dim -> absolute
        return len(shape) + dim_neg

    # ---- tensor parallel dim ------------------------------------------
    tp_dim: Optional[int] = None
    if is_moe_ffn and key in _MOE_EXPERT and nd >= 3:
        tp_dim = logical(-3)           # expert dim: EP
    elif key in _HEAD_LEADING and nd >= 3:
        tp_dim = logical(-3)           # per-head stacks
    elif key == "tokens" and nd >= 2:
        tp_dim = logical(-2)           # vocab rows
    elif key in _COL and nd >= 2:
        tp_dim = logical(-1)
    elif key in _ROW and nd >= 2:
        tp_dim = logical(-2)
    elif key in _BIAS_COL and nd >= 1:
        tp_dim = logical(-1)
    elif key == "conv" and nd >= 2:
        tp_dim = logical(-1)           # channel dim follows w_in's columns
    if tp_dim is not None and "model" in axis_names(mesh) and _divides(
            shape[tp_dim], model_size):
        spec[tp_dim] = "model"
    else:
        tp_dim = None

    # ---- FSDP dim ------------------------------------------------------
    if fsdp_params and fsdp_axes and nd >= 2:
        total = 1
        for s in shape:
            total *= s
        if total >= 1 << 16:
            # biggest unassigned *weight* dim (skip stacked layer dims)
            cands = [d for d in range(n_stack, len(shape))
                     if spec[d] is None and _divides(shape[d], fsdp_size)]
            if cands:
                best = max(cands, key=lambda d: shape[d])
                spec[best] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    return tuple(spec)


def _walk(tree: Any, fn, n_stack: int = 0, is_moe: bool = False):
    """Recurse mirroring the param dict structure, tracking context."""
    if isinstance(tree, dict):
        moe_here = is_moe or ("router" in tree and "w_gate" in tree)
        return {k: _walk(v, fn, n_stack, moe_here) if isinstance(v, (dict, list))
                else fn(k, v, n_stack, moe_here)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, n_stack, is_moe) for v in tree]
    return fn("", tree, n_stack, is_moe)


def param_shardings(cfg: ModelConfig, pcfg: ParallelConfig, param_specs: Any,
                    mesh) -> Any:
    """The spec tree of a model's params in the reference's layout
    (``models.convert.to_reference``, or its :class:`TensorSpec` tree):
    every leaf under ``groups`` carries one leading stacked-repeats dim."""
    fsdp = fsdp_axes(mesh) if pcfg.fsdp_params else ()

    def for_subtree(subtree: Any, n_stack: int):
        def leaf(key, v, ns, moe):
            return _leaf_spec(key, tuple(v.shape), n_stack=ns, is_moe_ffn=moe,
                              mesh=mesh, fsdp_axes=fsdp,
                              fsdp_params=pcfg.fsdp_params)
        return _walk(subtree, leaf, n_stack)

    out: Dict[str, Any] = {}
    for name, sub in param_specs.items():
        if name == "groups":
            # each group's params carry ONE leading stacked-repeats dim
            out[name] = [for_subtree(g, 1) for g in sub]
        else:
            out[name] = for_subtree(sub, 0)
    return out


def _dp(mesh) -> Tuple[Tuple[str, ...], int]:
    dp = fsdp_axes(mesh)
    size = 1
    for a in dp:
        size *= axis_sizes(mesh)[a]
    return dp, size


def batch_shardings(mesh, batch_specs: Dict[str, Any]) -> Dict[str, Spec]:
    """Shard the global batch dim over every data-parallel axis."""
    dp, dp_size = _dp(mesh)
    out = {}
    for k, v in batch_specs.items():
        spec: list = [None] * len(v.shape)
        if v.shape and _divides(v.shape[0], dp_size):
            spec[0] = dp if len(dp) > 1 else dp[0]
        out[k] = tuple(spec)
    return out


# cache leaf name -> (base rank, batch dim, seq dim) in the *unstacked*
# layout; seq=None for O(1) state caches
_CACHE_DIMS = {
    "k": (4, 0, 2), "v": (4, 0, 2),             # (B, Hkv, S, dh)
    "latent": (3, 0, 1), "k_rope": (3, 0, 1),   # (B, S, r)
    "ssm": (4, 0, None), "conv": (3, 0, None),  # mamba2 states
    "C": (4, 0, None), "c": (2, 0, None),       # xlstm states
    "n": (2, 0, None), "h": (2, 0, None),
}


def cache_seq_dim(name: str) -> Optional[int]:
    """The sequence dim of one layer's cache leaf ``name`` (the unstacked
    layout), or ``None`` for a state of O(1) size."""
    dims = _CACHE_DIMS.get(name)
    return None if dims is None else dims[2]


def _cache_leaf(name: str, shape: Tuple[int, ...], mesh) -> Spec:
    dp, dp_size = _dp(mesh)
    model_size = axis_sizes(mesh).get("model", 1)
    dp_entry = dp if len(dp) > 1 else (dp[0] if dp else None)
    spec: list = [None] * len(shape)
    dims = _CACHE_DIMS.get(name)
    if dims is not None and len(shape) >= dims[0]:
        base_rank, b0, s0 = dims
        off = len(shape) - base_rank          # leading stacked-reps dims
        bdim = b0 + off
        sdim = (s0 + off) if s0 is not None else None
        batch_ok = _divides(shape[bdim], dp_size)
        if batch_ok:
            spec[bdim] = dp_entry
        if sdim is not None:
            if _divides(shape[sdim], model_size):
                spec[sdim] = "model"
            if not batch_ok and spec[sdim] == "model" \
                    and _divides(shape[sdim], dp_size * model_size):
                spec[sdim] = dp + ("model",)      # B=1: seq over both
            elif not batch_ok and spec[sdim] is None \
                    and _divides(shape[sdim], dp_size):
                spec[sdim] = dp_entry
    return tuple(spec)


def cache_shardings(mesh, cache_specs: Any) -> Any:
    """Specs for the serving caches (``models.model.init_caches``' tree).

    Grouped layout (leaves carry a leading stacked-reps dim): batch over
    the data axes; sequence over ``model`` — the flash-decode layout.  For
    B=1 long-context cells the sequence dim takes the data axes as well.
    A leaf is named by the innermost dict key above it."""
    def walk(node: Any, name: str):
        if isinstance(node, dict):
            return {k: walk(v, str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return _cache_leaf(name, tuple(node.shape), mesh)
    return walk(cache_specs, "")


def replicated(mesh, tree: Any) -> Any:
    """A fully replicated spec (``()``) for every leaf of ``tree``."""
    from ..train.tree import tree_map
    return tree_map(lambda _: (), tree)


def constrain_like_params(cfg: ModelConfig, pcfg: ParallelConfig,
                          tree: Any) -> Any:
    """The *unstacked* per-layer param specs re-asserted on one layer's
    params under the ambient mesh (the reference's scan-body constraint,
    which keeps the FSDP gather per layer).  A leaf that is not a DTensor,
    or no ambient mesh, passes through unchanged."""
    mesh = current_mesh()
    if mesh is None or not axis_names(mesh):
        return tree
    fsdp = fsdp_axes(mesh) if pcfg.fsdp_params else ()

    def leaf(key, v, ns, moe):
        sp = _leaf_spec(key, tuple(v.shape), n_stack=0, is_moe_ffn=moe,
                        mesh=mesh, fsdp_axes=fsdp,
                        fsdp_params=pcfg.fsdp_params)
        return constrain_to(v, sp)

    return _walk(tree, leaf, 0)


# -- specs as DTensor placements ------------------------------------------------

def placements(spec: Spec, mesh) -> List[Any]:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names that axis,
    else ``Replicate()``.  Where two mesh dims shard one tensor dim
    (``("pod", "data")``) both are ``Shard(d)``, split in mesh-dim order
    as the reference's tuple entry is."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dim = None
        for d, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if name in names:
                dim = d
        out.append(Shard(dim) if dim is not None else Replicate())
    return out


def clean_spec(shape, axes, mesh) -> tuple:
    """The reference's spec cleaning: drop axes ``mesh`` lacks and axes
    whose size does not divide the dimension (no padded shards)."""
    names = set(axis_names(mesh))
    sizes = axis_sizes(mesh)
    clean = []
    for dim, a in zip(shape, axes):
        entry = None
        cands = a if isinstance(a, tuple) else (a,) if a else ()
        present = tuple(n for n in cands if n in names)
        if present:
            prod = 1
            for n in present:
                prod *= sizes[n]
            if dim % prod == 0:
                entry = present if len(present) > 1 else present[0]
        clean.append(entry)
    return tuple(clean)


def constrain_to(x, spec: tuple):
    """Redistribute a DTensor ``x`` to ``spec`` on its own mesh; any other
    tensor passes through."""
    if not is_dtensor(x):
        return x
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a tensor of ``shape`` laid out by ``spec``
    (the rules never pad, so every split is even)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            out[d] //= sizes[name]
    return tuple(out)


def per_device_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors or :class:`TensorSpec`
    leaves) laid out by ``specs``."""
    from ..train.tree import leaves
    total = 0
    for leaf, spec in zip(leaves(tree), spec_leaves(specs)):
        n = 1
        for s in local_shape(tuple(leaf.shape), spec, mesh):
            n *= s
        total += n * torch.empty((), dtype=leaf.dtype).element_size()
    return total


def spec_leaves(specs: Any) -> List[Spec]:
    """The specs of a spec tree in the flattening order of the tree it
    describes (a spec is a tuple, so a plain tree walk would descend into
    it)."""
    out: List[Spec] = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f))
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            out.append(node)
    walk(specs)
    return out


def shard_region(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[slice, ...]:
    """This rank's region (one slice per dim) of a tensor of ``shape``
    laid out by ``spec`` on ``mesh``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    lshape, offset = compute_local_shape_and_global_offset(
        shape, mesh, placements(spec, mesh))
    return tuple(slice(o, o + n) for o, n in zip(offset, lshape))


def as_dtensor(local: torch.Tensor, shape: Tuple[int, ...], spec: Spec,
               mesh):
    """A DTensor of global ``shape`` laid out by ``spec`` whose shard on
    this rank is ``local``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def local_chunk(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of ``t`` laid out by ``spec`` on ``mesh`` (a
    view)."""
    region = shard_region(tuple(t.shape), spec, mesh)
    for d, sl in enumerate(region):
        t = t.narrow(d, sl.start, sl.stop - sl.start)
    return t


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s tensors as DTensors on ``mesh`` laid out by ``specs``.
    Every rank holds the whole tensor (made from one seed) and keeps a
    copy of its own shard: no collective runs.  A meta tensor becomes a
    DTensor of meta shards of the right local shape; a 0-d leaf under a
    ``()`` spec (the optimizer's step) stays a plain tensor."""
    from ..train.tree import leaves, unflatten

    out = []
    for t, spec in zip(leaves(tree), spec_leaves(specs)):
        if t.ndim == 0 and spec == ():
            out.append(t)
            continue
        if t.device.type == "meta":
            local = torch.empty(local_shape(tuple(t.shape), spec, mesh),
                                dtype=t.dtype, device="meta")
        else:
            local = local_chunk(t.detach(), spec, mesh).contiguous().clone()
        out.append(as_dtensor(local, tuple(t.shape), spec, mesh))
    return unflatten(tree, out)


def gather_full(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` gathered whole on every rank (a
    collective: every rank calls it); other leaves pass through."""
    from ..train.tree import tree_map
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t,
                    tree)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


# -- from the stored layout to the compute layout ------------------------------

def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``."""
    return type(x).__name__ == "DTensor"


def _model_dim(leaf) -> Optional[int]:
    """The tensor dim ``leaf`` (a DTensor) is sharded on over ``model``."""
    from torch.distributed.tensor import Shard
    names = axis_names(leaf.device_mesh)
    if "model" not in names:
        return None
    pl = leaf.placements[names.index("model")]
    return pl.dim if isinstance(pl, Shard) else None


def _tp_block(cfg: ModelConfig, node: Dict[str, Any]) -> bool:
    """Whether a mixer or FFN dict computes tensor-parallel: a GQA block
    whose q, k, v columns and o rows are sharded over ``model`` in whole
    heads; an MLA block whose ``wq``, ``w_uk`` and ``w_uv`` columns and
    ``wo`` rows are (its ``w_dkv`` is gathered whole, :data:`_WHOLE`); a
    dense MLP whose hidden columns and rows are; a MoE FFN whose expert
    stacks are sharded on their expert dim (expert parallel; its router is
    whole, its shared experts column- and row-parallel where their width
    divides ``model``, else whole); a Mamba-2 block whose H = d_inner / P
    heads divide ``model``; or an mLSTM block whose ``w_q``, ``w_k`` and
    ``w_v`` are sharded on their head dim (H divides ``model``).  The two
    recurrent blocks compute the rank's heads (:func:`_recurrent_heads`).
    A dim that does not divide ``model`` is replicated by the rules, and
    the block then computes whole; so does a Mamba-2 block whose heads do
    not divide ``model``."""
    leaf = next((v for v in node.values() if is_dtensor(v)), None)
    if leaf is None:
        return False
    m = axis_sizes(leaf.device_mesh).get("model", 1)
    kind = _recurrent_kind(node)
    if kind == "mamba2":
        return node["A_log"].shape[-1] % m == 0
    if kind == "mlstm":
        return all(_model_dim(node[k]) == node[k].ndim - 3
                   for k in ("w_q", "w_k", "w_v"))

    def col(k):
        return k not in node or _model_dim(node[k]) == node[k].ndim - 1

    def row(k):
        return _model_dim(node[k]) == 0

    if {"wq", "wk", "wv", "wo"} <= set(node) and "w_dkv" not in node:
        return (cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
                and all(col(k) for k in ("wq", "wk", "wv", "bq", "bk", "bv"))
                and row("wo"))
    if {"wq", "w_dkv", "w_uk", "w_uv", "wo"} <= set(node):
        return (cfg.n_heads % m == 0
                and all(col(k) for k in ("wq", "w_uk", "w_uv"))
                and row("wo"))
    if "router" in node and _MOE_EXPERT <= set(node):
        return all(_model_dim(node[k]) == node[k].ndim - 3
                   for k in _MOE_EXPERT)
    if "tokens" in node and cfg.n_codebooks == 1:
        # the vocabulary: the table's rows and the head's columns
        return (_model_dim(node["tokens"]) == node["tokens"].ndim - 2
                and col("head"))
    if set(node) in ({"w_gate", "w_up", "w_down"},
                     {"w_up", "b_up", "w_down", "b_down"}):
        return (all(col(k) for k in ("w_gate", "w_up", "b_up"))
                and row("w_down"))
    return False


# leaves gathered whole over ``model`` in a block that is not: MLA's
# down-projection feeds every head (the rules shard its columns)
_WHOLE = {"w_dkv"}


def _recurrent_kind(node: Dict[str, Any]) -> Optional[str]:
    """``"mamba2"`` or ``"mlstm"`` for those blocks' parameter dicts, else
    ``None``."""
    if {"w_in", "conv", "A_log"} <= set(node):
        return "mamba2"
    if {"w_up", "w_q", "w_k", "w_v", "w_gates"} <= set(node):
        return "mlstm"
    return None


def _head_slices(shapes: Dict[str, Tuple[int, ...]], key: str, rank: int,
                 m: int) -> Tuple[int, List[Tuple[int, int]]]:
    """Where leaf ``key`` of a Mamba-2 or mLSTM block (its leaves'
    ``shapes``) holds rank ``rank``'s H/m heads of ``m``: a negative dim
    and the ``(start, length)`` pieces along it, in order.  Mamba-2's
    fused ``w_in`` is ``[z | x | B | C | dt]`` and its ``conv`` ``[x | B |
    C]``: the rank's columns of z, x and dt and every column of ``B`` and
    ``C``.  The mLSTM's ``w_up`` is ``[x_m | z]``, its ``gate_bias``
    ``[input gates | forget gates]``.  The widths come from the shapes
    (H from ``A_log`` or ``w_q``, d_inner from ``norm_scale``)."""
    d_inner = shapes["norm_scale"][-1]
    if "A_log" in shapes:
        H = shapes["A_log"][-1]
        N = (shapes["conv"][-1] - d_inner) // 2
    else:
        H = shapes["w_q"][-3]
    if H % m:
        raise ValueError(f"{H} heads do not divide a model axis of {m}")
    hl, h0 = H // m, rank * (H // m)
    w, c0 = d_inner // m, rank * (d_inner // m)
    if "A_log" in shapes:
        pieces = {
            "w_in": (-1, [(c0, w), (d_inner + c0, w), (2 * d_inner, 2 * N),
                          (2 * d_inner + 2 * N + h0, hl)]),
            "conv": (-1, [(c0, w), (d_inner, 2 * N)]),
            "w_out": (-2, [(c0, w)]),
            "A_log": (-1, [(h0, hl)]), "D": (-1, [(h0, hl)]),
            "dt_bias": (-1, [(h0, hl)]),
        }
    else:
        pieces = {
            "w_up": (-1, [(c0, w), (d_inner + c0, w)]),
            "conv": (-1, [(c0, w)]),
            "w_q": (-3, [(h0, hl)]), "w_k": (-3, [(h0, hl)]),
            "w_v": (-3, [(h0, hl)]),
            "w_gates": (-2, [(c0, w)]),
            "gate_bias": (-1, [(h0, hl), (H + h0, hl)]),
            "w_down": (-2, [(c0, w)]),
        }
    pieces["norm_scale"] = (-1, [(c0, w)])
    return pieces[key]


def _narrow(t: torch.Tensor, dim: int,
            pieces: List[Tuple[int, int]]) -> torch.Tensor:
    """The ``pieces`` of ``t`` along ``dim``, concatenated (a view where
    they are one run)."""
    runs: List[List[int]] = []
    for start, n in pieces:
        if runs and runs[-1][0] + runs[-1][1] == start:
            runs[-1][1] += n
        else:
            runs.append([start, n])
    if len(runs) == 1:
        start, n = runs[0]
        return t if n == t.shape[dim] else t.narrow(dim, start, n)
    return torch.cat([t.narrow(dim, a, n) for a, n in runs], dim=dim)


def _recurrent_heads(node: Dict[str, Any], grads: bool) -> Dict[str, Any]:
    """A Mamba-2 or mLSTM block's leaves (DTensors) as this rank's heads
    (:func:`_head_slices`).  A leaf whose stored ``model`` shard is those
    heads' slice keeps it (the mLSTM's ``w_q``, ``w_k``, ``w_v``, ``conv``
    and ``w_down``); any other is gathered whole, transient, and narrowed.
    The reference's rules split the fused columns contiguously, so a
    stored shard of ``w_in`` is not the rank's heads.  A narrowed leaf's
    gradient is this rank's part alone, zero outside its slice and, for
    ``B``/``C`` and ``w_gates``, a partial sum: it flows back as
    ``Partial`` over ``model``, so the stored shards receive the sum over
    the model ranks."""
    mesh = next(iter(node.values())).device_mesh
    m = axis_sizes(mesh)["model"]
    rank = mesh.get_local_rank("model")
    shapes = {k: tuple(v.shape) for k, v in node.items()}
    out = {}
    for k, v in node.items():
        dim, pieces = _head_slices(shapes, k, rank, m)
        n = v.shape[dim] // m
        if pieces == [(rank * n, n)] and _model_dim(v) == v.ndim + dim:
            out[k] = _to_compute(v, True, grads)
        else:
            out[k] = _narrow(_to_compute(v, False, grads, model_partial=True),
                             dim, pieces)
    return out


def _to_compute(leaf, keep_model: bool, grads: bool,
                model_partial: bool = False):
    """One DTensor leaf gathered over the data axes (and over ``model``
    unless ``keep_model``), as a local tensor.  Its gradient flows back as
    a partial sum over the data axes (each rank's batch differs), so the
    stored shard receives the reduce-scatter of it; with
    ``model_partial`` over ``model`` too (a leaf gathered whole of which
    each model rank computes a part)."""
    from torch.distributed.tensor import Partial, Replicate
    names = axis_names(leaf.device_mesh)
    target, grad_pl = [], []
    for name, pl in zip(names, leaf.placements):
        if name == "model" and keep_model:
            target.append(pl)
            grad_pl.append(pl)
        else:
            target.append(Replicate())
            grad_pl.append(Partial() if name != "model" or model_partial
                           else Replicate())
    full = leaf.redistribute(leaf.device_mesh, target)
    return full.to_local(grad_placements=grad_pl if grads else None)


def gather_for_compute(cfg: ModelConfig, tree: Any, *, tp: bool = True,
                       grads: bool = False, attention: bool = True,
                       heads: bool = True) -> Any:
    """A parameter (sub)tree of DTensors as the local tensors the model
    code computes on: gathered over the FSDP axes, and over ``model``
    except, with ``tp``, in the blocks that compute tensor-parallel
    (:func:`_tp_block`: each rank then holds whole heads of q, k, v and o,
    its columns of the MLP's hidden dim, its E/m experts, or its H/m
    heads of a Mamba-2 or mLSTM block, and ``layers.copy_to_model`` /
    ``reduce_from_model`` bracket the block).  ``attention=False`` gathers
    the GQA blocks whole and ``heads=False`` the MLA, Mamba-2 and mLSTM
    blocks: a serving decode step passes both (GQA's and MLA's cores read
    every head of a sequence-sharded cache, the recurrent blocks step
    every head).  A prefill keeps every block's heads local: GQA's new
    keys and values move into the cache's layout by an all-to-all
    (:func:`kv_heads_local`), MLA's latent cache holds no heads, and the
    recurrent blocks all-gather their new states' heads; training keeps
    them local too.  ``grads`` lets gradients flow
    back to the stored shards.  Leaves that are not DTensors pass
    through."""
    def keeps(node) -> bool:
        if not (tp and _tp_block(cfg, node)):
            return False
        if "w_dkv" in node or _recurrent_kind(node):
            return heads
        return attention or "wq" not in node

    def walk(node, keep_model: bool):
        if isinstance(node, dict):
            keep = keeps(node)
            if keep and _recurrent_kind(node):
                return _recurrent_heads(node, grads)
            return {k: walk(v, keep and k not in _WHOLE)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, keep_model) for v in node)
        if is_dtensor(node):
            return _to_compute(node, keep_model, grads)
        return node
    return walk(tree, False)


def model_shard(block: Dict[str, torch.Tensor], rank: int,
                m: int) -> Dict[str, torch.Tensor]:
    """One layer's mixer or FFN block (plain tensors) as rank ``rank`` of
    a ``model`` axis of ``m`` holds it under :func:`gather_for_compute`
    where the block computes tensor-parallel: each leaf the rules shard
    over ``model`` narrowed to the rank's slice (a view), the leaves of
    :data:`_WHOLE` whole; a Mamba-2 or mLSTM block's leaves narrowed to
    the rank's H/m heads (:func:`_head_slices`; a copy where the pieces
    are apart).  The block's function computes the rank's partial output
    from it with no process group (the collective is a step of its own),
    and the ``m`` partial outputs sum to the whole block's; a MoE FFN's
    shard starts at expert ``rank · E / m``.  A recurrent block's gated
    norm reads a sum of squares over every rank's channels, so Mamba-2's
    shards combine in two steps (``ssm.mamba2_mix`` at ``head_offset =
    rank · H / m``, the sums of squares summed, then
    ``layers.rms_project``); an mLSTM's gates read every channel too, and
    its shards combine through a model group."""
    if _recurrent_kind(block):
        shapes = {k: tuple(t.shape) for k, t in block.items()}
        return {k: _narrow(t, *_head_slices(shapes, k, rank, m))
                for k, t in block.items()}
    mesh = abstract_mesh((m,), ("model",))
    moe = "router" in block and _MOE_EXPERT <= set(block)
    out = {}
    for k, t in block.items():
        spec = () if k in _WHOLE else _leaf_spec(
            k, tuple(t.shape), n_stack=0, is_moe_ffn=moe, mesh=mesh,
            fsdp_axes=(), fsdp_params=False)
        for d, entry in enumerate(spec):
            if entry == "model":
                n = t.shape[d] // m
                t = t.narrow(d, rank * n, n)
        out[k] = t
    return out


def _over_model(x: torch.Tensor, mesh, *, to_all: bool) -> torch.Tensor:
    """``x`` (contiguous) over ``mesh``'s ``model`` group along dim 0:
    its ``m`` equal chunks sent to the ``m`` ranks in order and the chunks
    received stacked in rank order (``to_all``, an all-to-all), or every
    rank's ``x`` stacked in rank order (an all-gather)."""
    ops = torch.ops._c10d_functional
    group = mesh.get_group("model")
    m = group.size()
    if to_all:
        splits = [x.shape[0] // m] * m
        out = ops.all_to_all_single(x, splits, splits, group.group_name)
    else:
        out = ops.all_gather_into_tensor(x, m, group.group_name)
    return ops.wait_tensor(out)


def kv_heads_local(c):
    """A GQA layer's stored ``k`` or ``v`` cache, a DTensor ``(B, Hkv, L,
    dh)`` laid out by :func:`cache_shardings`, as the plain tensor a rank
    computing its ``n = Hkv / m`` heads writes into and attends over:
    ``(B_l, n, L, dh)``, its batch rows as stored and rank ``r``'s heads
    ``[r·n, (r+1)·n)``, the slice its ``wk`` and ``wv`` shards hold; and a
    function that writes that tensor back into the stored shard, every
    position of it (those the call did not write come back unchanged).
    Where the sequence is on ``model`` both moves are an all-to-all over
    ``model``, heads for positions; where the rules replicate it there,
    the tensor is a narrow of the rank's shard and the write-back
    all-gathers every rank's heads.  Where the data axes shard the
    sequence too (a batch that does not divide them; ``model`` splits
    each data rank's block), the blocks are all-gathered over them, and
    the rank's own block written back."""
    from torch.distributed.tensor import Shard
    mesh = c.device_mesh
    names = axis_names(mesh)
    seq = [a for a, p in zip(names, c.placements)
           if isinstance(p, Shard) and p.dim == 2]
    local = c.to_local()
    m = mesh.size(names.index("model"))
    B, Hkv, Ls, dh = local.shape
    n = Hkv // m
    by_model, over_data = "model" in seq, len(seq) > ("model" in seq)
    if by_model:
        # the heads leading: chunk j is rank j's heads at this rank's
        # positions; received, chunk j is this rank's heads at rank j's
        got = _over_model(local.movedim(1, 0).contiguous(), mesh,
                          to_all=True)
        view = got.reshape(m, n, B, Ls, dh).permute(2, 1, 0, 3, 4) \
            .reshape(B, n, m * Ls, dh)
    else:
        view = local.narrow(1, mesh.get_local_rank("model") * n, n)
    block = view.shape[2]
    if over_data:
        view = _over_data(view.movedim(2, 0), mesh, gather=True) \
            .movedim(0, 2).contiguous()

    def write_back():
        part = view.narrow(2, data_rank(mesh) * block, block) \
            if over_data else view
        if by_model:
            parts = part.reshape(B, n, m, Ls, dh).permute(2, 1, 0, 3, 4)
            back = _over_model(parts.contiguous(), mesh, to_all=True)
        else:
            back = _over_model(part.movedim(1, 0).contiguous(), mesh,
                               to_all=False)
        local.copy_(back.reshape(Hkv, B, Ls, dh).movedim(0, 1))
    return view, write_back


def to_local(tree: Any) -> Any:
    """This rank's local shard of every DTensor leaf (a batch split over
    the data axes); other leaves pass through."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            return type(node)(walk(v) for v in node)
        return node.to_local() if is_dtensor(node) else node
    return walk(tree)


def data_parallel_size(leaf) -> int:
    """The product of the data axes' sizes on ``leaf``'s mesh (1 for a
    plain tensor)."""
    return data_size(leaf.device_mesh) if is_dtensor(leaf) else 1


def mean_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """A scalar each data-parallel rank computed over its own rows,
    averaged over ``mesh``'s data axes (unchanged with no mesh)."""
    if mesh is None or x.ndim:
        return x
    return data_mean(x, mesh)


def data_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` averaged element by element over ``mesh``'s data axes, in
    float32 and back to ``x``'s dtype (unchanged with no mesh or one data
    rank).  No gradient flows through the reduction."""
    from torch.distributed import _functional_collectives as funcol
    if mesh is None:
        return x
    dp, size = _dp(mesh)
    if size == 1:
        return x
    total = x.detach().to(torch.float32).reshape(-1)
    for a in dp:
        total = funcol.wait_tensor(funcol.all_reduce(
            total, "sum", (mesh, axis_names(mesh).index(a))))
    return (total / size).reshape(x.shape).to(x.dtype)


# -- a batch's rows over the data axes ------------------------------------------

def data_size(mesh) -> int:
    """The number of data-parallel ranks of ``mesh``: the product of its
    data axes' sizes (1 with no mesh)."""
    return 1 if mesh is None else _dp(mesh)[1]


def data_rank(mesh) -> int:
    """This rank's index among the data-parallel ranks of ``mesh``: its
    coordinates on the data axes read row-major in mesh-dim order, the
    order in which :func:`batch_shardings` splits a batch's rows."""
    sizes = axis_sizes(mesh)
    r = 0
    for a in fsdp_axes(mesh):
        r = r * sizes[a] + mesh.get_local_rank(a)
    return r


def rows_sharded(tree: Any) -> bool:
    """Whether a batch ``tree`` holds this rank's rows only: its leaves
    are DTensors whose first dim is split over a data axis (plain tensors
    hold every row)."""
    from torch.distributed.tensor import Shard
    from ..train.tree import leaves
    for leaf in leaves(tree):
        if is_dtensor(leaf):
            dp = fsdp_axes(leaf.device_mesh)
            return any(name in dp and isinstance(pl, Shard) and pl.dim == 0
                       for name, pl in zip(axis_names(leaf.device_mesh),
                                           leaf.placements))
    return False


def _over_data(x: torch.Tensor, mesh, gather: bool) -> torch.Tensor:
    """``x``'s rows all-gathered (``gather``) or summed and scattered over
    ``mesh``'s data axes, by the functional collectives."""
    ops = torch.ops._c10d_functional
    sizes = axis_sizes(mesh)
    axes = [a for a in fsdp_axes(mesh) if sizes[a] > 1]
    x = x.contiguous()
    # gathered, the innermost axis first: a block of the outer axis is the
    # inner ranks' rows in order; scattered, the outermost first
    for a in (reversed(axes) if gather else axes):
        name = mesh.get_group(a).group_name
        x = ops.wait_tensor(
            ops.all_gather_into_tensor(x, sizes[a], name) if gather
            else ops.reduce_scatter_tensor(x, "sum", sizes[a], name))
    return x


class _GatherRows(torch.autograd.Function):
    """Each data rank's rows gathered in data-rank order; the gradient
    summed over the data ranks and scattered back to each rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _over_data(x, mesh, gather=True)

    @staticmethod
    def backward(ctx, g):
        return _over_data(g, ctx.mesh, gather=False), None


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rows (dim 0) each data rank of ``mesh`` computed, gathered
    whole on every rank in data-rank order (:func:`data_rank`): an
    all-gather over the data axes whose backward is the reduce-scatter
    (a sum over the data ranks).  Where every rank's loss counts 1 / dp
    of the same whole-batch loss, that sum gives each rank's rows their
    whole gradient."""
    if data_size(mesh) == 1:
        return x
    return _GatherRows.apply(x, mesh)
