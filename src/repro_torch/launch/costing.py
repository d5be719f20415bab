"""Roofline accounting from traced steps on meta tensors.

The port of the reference package's ``launch/costing.py``.  The reference
reads XLA's cost analysis and parses the per-partition HLO text; the port
has no XLA, so it counts at the dispatch level while a step runs on meta
tensors (no storage, no arithmetic) under the mesh:

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions and attention products: what dominates a transformer
  step; elementwise arithmetic is not counted);
* HBM bytes from :class:`CostCounter`, the summed operand and result bytes
  of every op that moves data — in eager PyTorch each op is its own kernel
  that reads its operands from and writes its results to device memory,
  so every op counts except the views, broadcasts and factory fills the
  reference's ``_HBM_OPS`` drops too;
* collective bytes per kind (the reference's ``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``, ``collective-
  permute``) from the functional collectives the mesh issues: the
  parameter gathers and gradient reduce-scatters of the per-layer FSDP
  gather, the tensor-parallel all-reduces, the decode core's combine
  (collectives issued inside a DTensor op's own dispatch, such as the
  optimizer's grad-norm reduction of a few scalars, are not seen).

Each count is per device (this rank's local shards), multiplied by the
device count for global totals, as the reference multiplies its
per-partition analysis.  As in the reference, train and prefill cells are
costed from *probes* (one repeat-unit of each layer group, the
embed/unembed/loss boundary, the optimizer update) reassembled as

    total = boundary + Σ_g reps_g · unit_g (+ optimizer)

and the probes' FLOPs come from the ``naive`` attention core (the hand
kernels are ``ctypes`` calls no dispatch mode sees).  The reference's
HLO-text parsers (``_shape_bytes``, ``hbm_bytes_from_text``,
``collective_bytes_from_text``, ``cost_from_compiled``) have no
counterpart.
"""

from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import ModelConfig, ParallelConfig, ShapeConfig
from ..data.batches import input_specs
from ..distributed.sharding import (batch_shardings, distribute,
                                    gather_for_compute, param_shardings,
                                    to_local)
from ..models import model as M
from ..models.layers import apply_norm, unembed
from ..models.transformer import apply_unit, layer_groups
from ..train.optimizer import AdamWConfig, make_adamw
from .mesh import (HBM_BW, LINK_BW, PEAK_BF16_FLOPS, axis_sizes, fsdp_axes,
                   mesh_size, set_mesh)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the functional collectives, by the reference's kind
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

# ops that move no data of their own: factory fills (XLA broadcasts a
# constant into its consumer) and the metadata-only ops
_NO_HBM = {"empty", "empty_like", "empty_strided", "new_empty", "zeros",
           "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
           "new_full", "arange", "scalar_tensor", "lift_fresh", "detach",
           "alias", "_local_scalar_dense", "sym_size", "sym_stride", "expand",
           "broadcast_to", "wait_tensor"}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if type(t).__name__ == "DTensor" else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Per-device HBM bytes, collective bytes per kind, and the peak of
    live bytes allocated while the mode is on (storages made by the traced
    ops, each freed when its last reference dies); ``kept``, the live bytes
    when the traced function last called :func:`note_kept`."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.per_collective: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self.kept = 0
        self._seen: set = set()

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = _local(t).untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self.live -= n
        self._seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = _FUNCOL_KIND.get(name)
            if kind is not None:
                self.per_collective[kind] += sum(_nbytes(t)
                                                 for t in _tensors(out))
        elif name not in _NO_HBM and not _is_view(func):
            self.hbm_bytes += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in _tensors(out))
        if not _is_view(func):
            self._track(out)
        return out


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


@dataclass
class CostTerms:
    """Global (all-devices) totals + derived per-step roofline seconds.

    ``bytes_accessed`` is the HBM estimate (:class:`CostCounter`);
    ``raw_bytes`` is kept for the reference's algebra (here the same
    count: eager PyTorch fuses nothing)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = field(default_factory=dict)
    raw_bytes: float = 0.0

    def __add__(self, o: "CostTerms") -> "CostTerms":
        pc = dict(self.per_collective)
        for k, v in o.per_collective.items():
            pc[k] = pc.get(k, 0.0) + v
        return CostTerms(self.flops + o.flops,
                         self.bytes_accessed + o.bytes_accessed,
                         self.collective_bytes + o.collective_bytes, pc,
                         self.raw_bytes + o.raw_bytes)

    def scaled(self, k: float) -> "CostTerms":
        return CostTerms(self.flops * k, self.bytes_accessed * k,
                         self.collective_bytes * k,
                         {n: v * k for n, v in self.per_collective.items()},
                         self.raw_bytes * k)

    def roofline(self, n_chips: int, *, peak_flops: float = PEAK_BF16_FLOPS,
                 hbm_bw: float = HBM_BW,
                 link_bw: float = LINK_BW) -> Dict[str, float]:
        """The three per-step lower bounds on ``n_chips`` devices of the
        given peaks (default: an H100 SXM5 80GB at 700 W, ``launch.mesh``)
        and the dominant one."""
        t_compute = self.flops / (n_chips * peak_flops)
        t_memory = self.bytes_accessed / (n_chips * hbm_bw)
        t_coll = self.collective_bytes / (n_chips * link_bw)
        dominant = max(
            (("compute", t_compute), ("memory", t_memory),
             ("collective", t_coll)),
            key=lambda kv: kv[1],
        )[0]
        return {"t_compute_s": t_compute, "t_memory_s": t_memory,
                "t_collective_s": t_coll, "dominant": dominant,
                "bound_s": max(t_compute, t_memory, t_coll)}


@dataclass
class Traced:
    """What one traced call leaves: its per-device cost counts, the peak
    of bytes its ops kept live, the bytes live at its :func:`note_kept`
    (a forward pass's activations kept for the backward pass), and its
    result."""
    flops: float
    hbm_bytes: float
    per_collective: Dict[str, float]
    peak_bytes: int
    result: Any = None
    kept_bytes: int = 0

    def global_cost(self, n_devices: int) -> CostTerms:
        per = {k: float(v) * n_devices for k, v in self.per_collective.items()}
        return CostTerms(flops=self.flops * n_devices,
                         bytes_accessed=self.hbm_bytes * n_devices,
                         collective_bytes=sum(per.values()),
                         per_collective=per,
                         raw_bytes=self.hbm_bytes * n_devices)


# the counters of the traces running, innermost last
_COUNTERS: list = []


def trace(fn: Callable, *args, **kwargs) -> Traced:
    """Run ``fn`` once with the counters on (inputs on the meta device
    allocate and compute nothing)."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    counter = CostCounter()
    _COUNTERS.append(counter)
    try:
        with flops, counter:
            result = fn(*args, **kwargs)
    finally:
        _COUNTERS.pop()
    return Traced(float(flops.get_total_flops()), float(counter.hbm_bytes),
                  dict(counter.per_collective), counter.peak, result,
                  counter.kept)


def note_kept() -> None:
    """Record the live bytes of the innermost running :func:`trace` as
    its ``kept_bytes``."""
    if _COUNTERS:
        _COUNTERS[-1].kept = _COUNTERS[-1].live


# ---------------------------------------------------------------------------
# probes (train / prefill costing)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _act_spec(mesh, shape) -> Tuple:
    dp = fsdp_axes(mesh)
    size = 1
    for a in dp:
        size *= axis_sizes(mesh)[a]
    spec: list = [None] * len(shape)
    if shape and shape[0] % size == 0:
        spec[0] = dp if len(dp) > 1 else dp[0]
    return tuple(spec)


def _act(mesh, shape, dtype) -> torch.Tensor:
    """This rank's rows of a batch-sharded activation, as a meta tensor."""
    x = distribute({"x": _meta(shape, dtype)},
                   {"x": _act_spec(mesh, shape)}, mesh)["x"]
    return x.to_local()


def _grad(loss, inputs):
    leaves = [t for t in _tensors(inputs) if t.requires_grad]
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def _unit_probe(cfg: ModelConfig, pcfg: ParallelConfig, mesh,
                gi: int, B: int, S: int, *, with_grad: bool,
                attn_impl: str = "naive") -> Traced:
    """Cost of ONE application of group gi's repeat unit at (B, S), per
    device."""
    from ..train.tree import tree_map
    _reps, unit = layer_groups(cfg)[gi]
    dtype = getattr(torch, pcfg.param_dtype)
    full = M.param_specs(cfg, dtype)
    up_specs = tree_map(lambda t: t[:1], full["groups"][gi])
    up = distribute(up_specs, param_shardings(
        cfg, pcfg, {"groups": [up_specs]}, mesh)["groups"][0], mesh)
    shared = None
    if any(s.mixer == "shared_attn" for s in unit):
        shared = distribute(full["shared"], param_shardings(
            cfg, pcfg, {"shared": full["shared"]}, mesh)["shared"], mesh)
    cd = getattr(torch, pcfg.compute_dtype)
    # rows that do not divide the data ranks are whole on every rank
    replicated_rows = _act_spec(mesh, (B, S))[0] is None
    x = _act(mesh, (B, S, cfg.d_model), cd)
    pos_shape = (B, 3, S) if cfg.mrope else (B, S)
    positions = _act(mesh, pos_shape, torch.int32)
    if with_grad:
        up = tree_map(lambda p: p.detach().requires_grad_(True), up)
        x = x.requires_grad_(True)

    def fwd(up, x):
        tree = {"groups": up} if shared is None else {"groups": up,
                                                      "shared": shared}
        cp = M.compute_params(tree, cd, detach=not with_grad, gather=False)
        u0 = tree_map(lambda p: p[0], cp["groups"])
        u0 = gather_for_compute(cfg, u0, grads=with_grad)
        sh = (gather_for_compute(cfg, cp["shared"], grads=with_grad)
              if shared is not None else None)
        y, _aux, _ = apply_unit(cfg, unit, u0, sh, x, positions,
                                attn_impl=attn_impl, slstm_cost_proxy=True,
                                emb0=x, moe_replicated_rows=replicated_rows)
        return torch.sum(y.to(torch.float32))

    def probe():
        with set_mesh(mesh):
            if not with_grad:
                with torch.no_grad():
                    return fwd(up, x)
            with torch.enable_grad():
                # the model's own remat policy (models.model.remat_call);
                # what the forward pass leaves live is what it keeps
                loss = M.remat_call(pcfg.remat, fwd, up, x)
                note_kept()
                return _grad(loss, [up, x])

    return trace(probe)


def _boundary_probe(cfg: ModelConfig, pcfg: ParallelConfig, mesh,
                    shape: ShapeConfig, *, with_grad: bool) -> Traced:
    """Embed + final norm + unembed (+ loss grad) cost, per device."""
    dtype = getattr(torch, pcfg.param_dtype)
    full = M.param_specs(cfg, dtype)
    emb = {"embed": full["embed"], "final_norm": full["final_norm"]}
    eparams = distribute(emb, param_shardings(cfg, pcfg, emb, mesh), mesh)
    specs = input_specs(cfg, dataclasses.replace(shape, kind="train"))
    batch = {k: _meta(v.shape, v.dtype) for k, v in specs.items()}
    batch = to_local(distribute(batch, batch_shardings(mesh, batch), mesh))
    cd = getattr(torch, pcfg.compute_dtype)
    if with_grad:
        from ..train.tree import tree_map
        eparams = tree_map(lambda p: p.detach().requires_grad_(True),
                           eparams)

    def fn():
        cp = M.compute_params(eparams, cd, detach=not with_grad,
                              gather=False)
        cp = gather_for_compute(cfg, cp, grads=with_grad)
        x, _ = M._embed_batch(cfg, cp, batch, cd)
        x = apply_norm(cfg, cp["final_norm"], x)
        logits = unembed(cfg, cp["embed"], x)
        return M.lm_loss(cfg, logits, batch["targets"].long())

    def probe():
        with set_mesh(mesh):
            if not with_grad:
                with torch.no_grad():
                    return fn()
            with torch.enable_grad():
                return _grad(fn(), eparams)

    return trace(probe)


def _optimizer_probe(cfg: ModelConfig, pcfg: ParallelConfig,
                     ocfg: AdamWConfig, mesh) -> Traced:
    """One AdamW update of the whole parameter tree, per device."""
    from ..train.optimizer import OptState
    dtype = getattr(torch, pcfg.param_dtype)
    specs = M.param_specs(cfg, dtype)
    pshard = param_shardings(cfg, pcfg, specs, mesh)
    opt_init, opt_update = make_adamw(ocfg, pcfg)
    params = distribute(specs, pshard, mesh)
    grads = distribute(specs, pshard, mesh)
    opt = opt_init(specs)
    opt = OptState(step=opt.step, mu=distribute(opt.mu, pshard, mesh),
                   nu=distribute(opt.nu, pshard, mesh))

    def probe():
        with set_mesh(mesh):
            return opt_update(grads, opt, params)[:2]

    return trace(probe)


def probed_cost(cfg: ModelConfig, pcfg: ParallelConfig, mesh,
                shape: ShapeConfig, *, ocfg: Optional[AdamWConfig] = None,
                attn_bytes_impl: str = "blocked",
                ) -> Tuple[CostTerms, Dict[str, CostTerms]]:
    """Reassembled global cost for a train/prefill cell.

    Returns (total, per-part breakdown).

    ``attn_bytes_impl`` selects the byte model for attention in the memory
    probe: ``"blocked"`` (the plain runtime — float32 score blocks hit
    HBM) or ``"kernel_proxy"`` (the fused kernel — q/k/v/o streams
    only)."""
    return probe_cell(cfg, pcfg, mesh, shape, ocfg=ocfg,
                      attn_bytes_impl=attn_bytes_impl)[:2]


def probe_cell(cfg: ModelConfig, pcfg: ParallelConfig, mesh,
               shape: ShapeConfig, *, ocfg: Optional[AdamWConfig] = None,
               attn_bytes_impl: str = "blocked"):
    """:func:`probed_cost`'s (total, parts), and the probes' live bytes
    per device: ``peak`` (each probe's peak), ``kept`` (each group's
    repeat unit: the bytes its forward pass keeps for its backward pass
    under ``pcfg.remat``) and ``stored`` (the step's, Σ_g reps_g · kept_g:
    what the forward passes of every layer keep at once)."""
    with_grad = shape.kind == "train"
    B, S = shape.global_batch, shape.seq_len
    n = mesh_size(mesh)
    parts: Dict[str, CostTerms] = {}
    peaks: Dict[str, int] = {}
    kept: Dict[str, int] = {}
    stored = 0
    total = CostTerms()
    attn = ("attn", "shared_attn", "mla")
    for gi, (reps, unit) in enumerate(layer_groups(cfg)):
        # FLOPs from the naive core (the full S² arithmetic); bytes and
        # collectives from the runtime byte model (naive's materialized
        # S² scores would fake the memory term)
        u_flops = _unit_probe(cfg, pcfg, mesh, gi, B, S, with_grad=with_grad,
                              attn_impl="naive")
        if any(s.mixer in attn for s in unit):
            u_mem = _unit_probe(cfg, pcfg, mesh, gi, B, S,
                                with_grad=with_grad,
                                attn_impl=attn_bytes_impl)
        else:
            u_mem = u_flops
        g_mem = u_mem.global_cost(n)
        u = CostTerms(flops=u_flops.global_cost(n).flops,
                      bytes_accessed=g_mem.bytes_accessed,
                      collective_bytes=g_mem.collective_bytes,
                      per_collective=g_mem.per_collective)
        parts[f"group{gi}_x{reps}"] = u.scaled(reps)
        peaks[f"group{gi}"] = u_mem.peak_bytes
        kept[f"group{gi}"] = u_mem.kept_bytes
        stored += reps * u_mem.kept_bytes
        total = total + u.scaled(reps)
    b = _boundary_probe(cfg, pcfg, mesh, shape, with_grad=with_grad)
    parts["boundary"] = b.global_cost(n)
    peaks["boundary"] = b.peak_bytes
    total = total + parts["boundary"]
    if with_grad:
        o = _optimizer_probe(cfg, pcfg, ocfg or AdamWConfig(), mesh)
        parts["optimizer"] = o.global_cost(n)
        peaks["optimizer"] = o.peak_bytes
        total = total + parts["optimizer"]
    return total, parts, {"peak": peaks, "kept": kept, "stored": stored}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·tokens (the usefulness yardstick), per step."""
    n_active = M.active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: 1 token/seq
