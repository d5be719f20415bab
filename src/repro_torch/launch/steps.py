"""Cell programs: (arch × shape × mesh) -> a step + its layouts.

The port of the reference package's ``launch/steps.py``.  One *cell* is an
assigned (architecture, input-shape) pair on a mesh.  ``build_cell`` returns
everything the dry run, trainer, and server need:

* ``kind="train"``   — full train step (grad accumulation + AdamW update),
  blocked attention.
* ``kind="prefill"`` — prompt pass writing KV/latent/SSM caches.
* ``kind="decode"``  — one-token serve step against a seq_len-deep cache,
  on the sequence-sharded ``flash_decode`` core by default.

``args`` are :class:`~repro_torch.train.step.TensorSpec` trees and the
layouts are ``distributed.sharding`` spec trees.  The counterpart of the
reference's ``lower_cell`` is :func:`trace_cell`: the port has no XLA
lowering, so it runs the step once on meta tensors laid out on the mesh
(no storage, no arithmetic) and returns what the dry run and costing
read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import SHAPES, get_config
from ..configs.base import ModelConfig, ParallelConfig, ShapeConfig
from ..data.batches import input_specs
from ..distributed.sharding import (batch_shardings, cache_shardings,
                                    distribute, param_shardings,
                                    per_device_bytes)
from ..models import model as M
from ..models.convert import unstack
from ..train.optimizer import AdamWConfig, OptState
from ..train.step import (TensorSpec, TrainState, make_train_step,
                          train_state_specs)
from ..train.tree import tree_map
from .mesh import axis_sizes, fsdp_axes, mesh_size, set_mesh


@dataclass
class CellProgram:
    """A built cell: the step plus its static metadata."""
    name: str
    kind: str
    fn: Callable                     # the step, on tensors laid out
    args: Tuple[Any, ...]            # TensorSpec trees
    in_shardings: Tuple[Any, ...]    # spec trees, one per arg
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    static: Dict[str, Any]


def default_pcfg(kind: str, *, scan_layers: bool = True,
                 n_microbatches: int = 0) -> ParallelConfig:
    """``n_microbatches=0`` means auto-size to the memory budget."""
    if kind == "train":
        return ParallelConfig(scan_layers=scan_layers, remat="block",
                              n_microbatches=n_microbatches)
    # serving: bf16 everywhere, no FSDP gather in the hot loop unless the
    # model cannot fit otherwise (the rules shard what divides)
    return ParallelConfig(scan_layers=scan_layers, remat="none",
                          param_dtype="bfloat16", fsdp_params=True)


def opt_shardings_like(pshard: Any, mesh) -> OptState:
    """OptState specs mirroring the param specs (float32 moments); the
    step count replicated (a plain tensor on every rank)."""
    return OptState(step=(), mu=pshard, nu=pshard)


def build_cell(
    arch: str,
    shape_name,
    mesh,
    *,
    pcfg: Optional[ParallelConfig] = None,
    ocfg: Optional[AdamWConfig] = None,
    attn_impl: Optional[str] = None,
) -> CellProgram:
    """Assemble the step program for one (arch, shape) cell; ``shape_name``
    names a ``SHAPES`` entry or is a ``ShapeConfig`` (a cell cut to fit
    fewer devices)."""
    cfg = get_config(arch)
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    kind = shape.kind
    pcfg = pcfg or default_pcfg(kind)
    ocfg = ocfg or AdamWConfig()

    if kind == "train":
        return _build_train(cfg, shape, mesh, pcfg, ocfg,
                            attn_impl or "blocked")
    if kind == "prefill":
        return _build_prefill(cfg, shape, mesh, pcfg,
                              attn_impl or "blocked")
    return _build_decode(cfg, shape, mesh, pcfg,
                         attn_impl or "flash_decode")


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def auto_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      *, residual_budget_gib: float = 4.0) -> int:
    """Pick the cell's microbatch count.

    The smallest power-of-two count keeping the per-device
    remat-stored residual stack under budget (B/n must stay divisible by
    the data-parallel degree so the batch dim shards)."""
    dp = 1
    for a in fsdp_axes(mesh):
        dp *= axis_sizes(mesh)[a]
    B, S = shape.global_batch, shape.seq_len
    resid = cfg.n_layers * B * S * cfg.d_model * 2 / dp   # bf16 per device
    n = 1
    while (resid / n > residual_budget_gib * 2**30
           and n * 2 <= max(1, B // dp)):
        n *= 2
    return n


def _build_train(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 pcfg: ParallelConfig, ocfg: AdamWConfig,
                 attn_impl: str) -> CellProgram:
    if pcfg.n_microbatches == 0:        # 0 = auto
        pcfg = dataclasses.replace(
            pcfg, n_microbatches=auto_microbatches(cfg, shape, mesh))
    state_specs = train_state_specs(cfg, ocfg, pcfg)
    pshard = param_shardings(cfg, pcfg, state_specs.params, mesh)
    state_shard = TrainState(params=pshard,
                             opt=opt_shardings_like(pshard, mesh))
    batch = input_specs(cfg, shape)
    bshard = batch_shardings(mesh, batch)
    step = make_train_step(cfg, ocfg, pcfg, attn_impl=attn_impl)

    def train_step(state, batch):
        new_state, metrics = step(state, batch)
        return new_state, metrics

    return CellProgram(
        name=f"{cfg.name}:{shape.name}", kind="train",
        fn=train_step, args=(state_specs, batch),
        in_shardings=(state_shard, bshard),
        out_shardings=(state_shard, None),
        donate_argnums=(0,),
        static={"cfg": cfg, "pcfg": pcfg, "ocfg": ocfg,
                "attn_impl": attn_impl},
    )


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _spec_tree(tree: Any) -> Any:
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


def _cache_specs(cfg: ModelConfig, pcfg: ParallelConfig, batch: int,
                 max_len: int):
    return _spec_tree(M.init_caches(cfg, pcfg, batch=batch, max_len=max_len,
                                    device="meta"))


def _param_specs_cast(cfg: ModelConfig, pcfg: ParallelConfig):
    return _spec_tree(M.param_specs(cfg, getattr(torch, pcfg.param_dtype)))


def _tokens(batch: Dict[str, Any]):
    return batch.get("tokens", batch.get("codes", batch.get("embeds")))


def _build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   pcfg: ParallelConfig, attn_impl: str) -> CellProgram:
    B, S = shape.global_batch, shape.seq_len
    specs = _param_specs_cast(cfg, pcfg)
    pshard = param_shardings(cfg, pcfg, specs, mesh)
    caches = _cache_specs(cfg, pcfg, B, S)
    cshard = cache_shardings(mesh, caches)
    batch = input_specs(cfg, shape)
    bshard = batch_shardings(mesh, batch)

    def prefill_step(params, caches, batch):
        logits, new_caches = M.decode_step(
            cfg, pcfg, unstack(params), caches, _tokens(batch), 0,
            attn_impl=attn_impl, last_only=True)
        return logits[..., -1, :], new_caches

    return CellProgram(
        name=f"{cfg.name}:{shape.name}", kind="prefill",
        fn=prefill_step, args=(specs, caches, batch),
        in_shardings=(pshard, cshard, bshard),
        out_shardings=(None, cshard),
        donate_argnums=(1,),
        static={"cfg": cfg, "pcfg": pcfg, "attn_impl": attn_impl},
    )


def _build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  pcfg: ParallelConfig, attn_impl: str) -> CellProgram:
    B, S = shape.global_batch, shape.seq_len
    specs = _param_specs_cast(cfg, pcfg)
    pshard = param_shardings(cfg, pcfg, specs, mesh)
    caches = _cache_specs(cfg, pcfg, B, S)
    cshard = cache_shardings(mesh, caches)
    batch = input_specs(cfg, shape)      # one new token per sequence
    bshard = batch_shardings(mesh, batch)

    def serve_step(params, caches, batch):
        # cache "full but one": the step appends token S-1 and attends to
        # the seq_len-deep history — the steady-state decode cost
        logits, new_caches = M.decode_step(
            cfg, pcfg, unstack(params), caches, _tokens(batch), S - 1,
            attn_impl=attn_impl, last_only=True)
        return logits[..., -1, :], new_caches

    return CellProgram(
        name=f"{cfg.name}:{shape.name}", kind="decode",
        fn=serve_step, args=(specs, caches, batch),
        in_shardings=(pshard, cshard, bshard),
        out_shardings=(None, cshard),
        donate_argnums=(1,),
        static={"cfg": cfg, "pcfg": pcfg, "attn_impl": attn_impl},
    )


# ---------------------------------------------------------------------------
# the trace used by the dry run (the counterpart of lower_cell)
# ---------------------------------------------------------------------------

@dataclass
class CellTrace:
    """A cell's step traced once on meta tensors under its mesh.

    ``argument_bytes_per_device``: the inputs one device holds (params,
    optimizer state or caches, batch) laid out by the cell's specs, of
    which ``param_bytes_per_device`` the parameters;
    ``temp_bytes_per_device``: the peak of bytes the step's ops kept live
    at once (activations, gathered weights, gradients, new state);
    ``peak_bytes_per_device``: their sum.  ``flops``, ``hbm_bytes`` and
    ``per_collective`` are per device (``launch.costing``)."""
    devices: int
    argument_bytes_per_device: int
    param_bytes_per_device: int
    temp_bytes_per_device: int
    flops: float
    hbm_bytes: float
    per_collective: Dict[str, float]

    @property
    def peak_bytes_per_device(self) -> int:
        return self.argument_bytes_per_device + self.temp_bytes_per_device

    def global_cost(self):
        """The traced step's counts over all devices (``CostTerms``)."""
        from .costing import Traced
        return Traced(self.flops, self.hbm_bytes, self.per_collective,
                      self.temp_bytes_per_device).global_cost(self.devices)


def _meta_tree(specs: Any) -> Any:
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def cell_arguments(prog: CellProgram, mesh) -> Tuple[Tuple[Any, ...], int]:
    """The cell's arguments as meta DTensors laid out on ``mesh``, and the
    bytes one device holds of them."""
    args, held = [], 0
    for spec, shard in zip(prog.args, prog.in_shardings):
        meta = _meta_tree(spec)
        held += per_device_bytes(spec, shard, mesh)
        args.append(distribute(meta, shard, mesh))
    return tuple(args), held


def _param_bytes(prog: CellProgram, mesh) -> int:
    spec, shard = prog.args[0], prog.in_shardings[0]
    if prog.kind == "train":
        spec, shard = spec.params, shard.params
    return per_device_bytes(spec, shard, mesh)


def trace_cell(prog: CellProgram, mesh) -> CellTrace:
    """Run the cell's step once on meta tensors under ``mesh`` (a
    ``DeviceMesh``, a fake process group's for the production sizes)."""
    from .costing import trace
    args, held = cell_arguments(prog, mesh)
    with set_mesh(mesh):
        t = trace(prog.fn, *args)
    return CellTrace(devices=mesh_size(mesh), argument_bytes_per_device=held,
                     param_bytes_per_device=_param_bytes(prog, mesh),
                     temp_bytes_per_device=t.peak_bytes, flops=t.flops,
                     hbm_bytes=t.hbm_bytes, per_collective=t.per_collective)
