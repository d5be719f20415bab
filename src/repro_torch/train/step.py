"""Train-step factory: microbatched gradient accumulation, mixed precision.

The port of the reference package's ``train/step.py``.  The training state
keeps the parameters as the reference's pytree (every leaf under
``groups`` stacked over its group's repeats, :func:`repro_torch.models.
convert.to_reference`), so the optimizer's weight decay and int8 blocks
and the checkpoints' leaf paths are the reference's.  The forward pass
reads that tree one layer per repeat (``convert.unstack``, views of the
stacked leaves) and ``torch.autograd`` differentiates the model's loss on
the ``"blocked"`` attention core, as the reference's ``jax.value_and_grad``
does; no kernel needs a backward pass.  As there, an sLSTM layer trains
on the cost proxy (``slstm_cost_proxy=True``: the recurrence's dense
stand-in), and MoE layers on the sorted capacity dispatch.  Microbatches
accumulate their gradients in float32, each divided by their number.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ParallelConfig
from ..models import model as M
from ..models.convert import to_reference, unstack
from ..radar._device import DeviceLike
from .optimizer import AdamWConfig, OptState, make_adamw
from .tree import leaves, tree_map, unflatten

Params = Any


class TrainState(NamedTuple):
    """Training state: parameters plus optimizer state."""
    params: Params
    opt: OptState


@dataclass(frozen=True)
class TensorSpec:
    """A leaf's shape and dtype, with no storage (restore planning)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_train_state(cfg: ModelConfig, ocfg: AdamWConfig,
                     pcfg: ParallelConfig, seed: int = 0, *,
                     device: DeviceLike = None) -> TrainState:
    """Random parameters for ``cfg`` (``models.model.init_params`` with
    ``seed``, in ``pcfg.param_dtype``) in the reference's layout, and zero
    optimizer state, on ``device`` (``None`` means ``"cuda"``)."""
    params = to_reference(M.init_params(
        cfg, seed, dtype=getattr(torch, pcfg.param_dtype), device=device))
    opt_init, _ = make_adamw(ocfg, pcfg)
    return TrainState(params=params, opt=opt_init(params))


def train_state_specs(cfg: ModelConfig, ocfg: AdamWConfig,
                      pcfg: ParallelConfig) -> TrainState:
    """The state's :class:`TensorSpec` tree, built on the meta device: no
    storage is allocated."""
    state = init_train_state(cfg, ocfg, pcfg, device="meta")
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), state)


def _split_microbatches(batch: Dict[str, Any], n: int):
    def split(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"global batch {B} % microbatches {n} != 0")
        return x.reshape(n, B // n, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(
    cfg: ModelConfig,
    ocfg: AdamWConfig,
    pcfg: ParallelConfig,
    *,
    attn_impl: str = "blocked",
    grad_transform: Optional[Callable[[Params], Params]] = None,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """Build the training step ``(state, batch) -> (state, metrics)``.

    ``grad_transform`` hooks a transform of the gradient tree (the
    reference's cross-pod compression) between accumulation and the
    optimizer."""
    _, opt_update = make_adamw(ocfg, pcfg)

    def loss_and_grads(params: Params, mb: Dict[str, Any]):
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = M.train_loss(cfg, pcfg, unstack(ps), mb,
                                         attn_impl=attn_impl,
                                         slstm_cost_proxy=True)
            grads = torch.autograd.grad(loss, leaves(ps))
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten(params, list(grads))

    def train_step(state: TrainState, batch: Dict[str, Any]):
        n = pcfg.n_microbatches
        if n <= 1:
            loss, metrics, grads = loss_and_grads(state.params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            losses, ms = [], []
            for mb in _split_microbatches(batch, n):
                loss_i, m_i, g = loss_and_grads(state.params, mb)
                grads = tree_map(lambda a, gi: a + gi.to(torch.float32) / n,
                                 grads, g)
                losses.append(loss_i)
                ms.append(m_i)
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([torch.as_tensor(m[k])
                                                  for m in ms]))
                       for k in ms[0]}
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, new_opt, opt_metrics = opt_update(grads, state.opt,
                                                      state.params)
        metrics = {**metrics, **opt_metrics, "loss_total": loss}
        return TrainState(new_params, new_opt), metrics

    return train_step
