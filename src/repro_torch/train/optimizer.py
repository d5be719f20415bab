"""AdamW + LR schedules, global-norm clipping, quantized moment option.

The port of the reference package's ``train/optimizer.py``: the optimizer
is a pair of functions ``init(params) -> state`` / ``update(grads, state,
params) -> (new_params, new_state, metrics)`` over trees of tensors
(:mod:`repro_torch.train.tree`), with the reference's arithmetic in
float32, so from the same parameters and gradients both packages take the
same step within float32 rounding.

``opt_moment_dtype="int8"`` stores each moment block-quantized (absmax
int8 over blocks of 256 values with a float32 scale per block, the second
moment in the square-root domain), as the reference does; the blocks run
over the stacked leaf, so the quantization is the reference's too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ParallelConfig
from .tree import leaves, tree_map

Params = Any
_F32 = torch.float32


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Cosine decay schedule with linear warmup."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(_F32)
        warm = peak_lr * step / max(1.0, warmup_steps)
        t = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        t = torch.clamp(t, 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant_schedule(lr_value: float
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Constant learning-rate schedule."""
    return lambda step: torch.tensor(lr_value, dtype=_F32,
                                     device=step.device)


# ---------------------------------------------------------------------------
# moment (de)quantization: block-wise absmax int8; the second moment is
# stored in the square-root domain to compress its dynamic range
# ---------------------------------------------------------------------------

_QBLOCK = 256


def _quantize(x: torch.Tensor, *, sqrt_domain: bool = False
              ) -> Dict[str, torch.Tensor]:
    if sqrt_domain:
        x = torch.sqrt(torch.clamp(x, min=0.0))
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _QBLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, _QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 \
        + 1e-12
    return {"q": torch.round(blocks / scale).to(torch.int8),
            "scale": scale.to(_F32)}


def _dequantize(q: Dict[str, torch.Tensor], shape, *,
                sqrt_domain: bool = False) -> torch.Tensor:
    flat = (q["q"].to(_F32) * q["scale"]).reshape(-1)
    x = flat[:math.prod(shape)].reshape(shape)
    return x * x if sqrt_domain else x


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdamWConfig:
    """AdamW hyperparameters."""
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    schedule: str = "cosine"          # cosine|constant


class OptState(NamedTuple):
    """AdamW optimizer state (moments plus step count)."""
    step: torch.Tensor                # int32 scalar
    mu: Params
    nu: Params


def make_adamw(ocfg: AdamWConfig, pcfg: ParallelConfig):
    """-> (init_fn, update_fn)."""
    sched = (cosine_schedule(ocfg.peak_lr, ocfg.warmup_steps,
                             ocfg.total_steps)
             if ocfg.schedule == "cosine" else constant_schedule(ocfg.peak_lr))
    mdt = pcfg.opt_moment_dtype

    def _zero_moment(p: torch.Tensor):
        if mdt == "int8":
            nb = -(-p.numel() // _QBLOCK)
            return {"q": torch.zeros((nb, _QBLOCK), dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.zeros((nb, 1), dtype=_F32,
                                         device=p.device)}
        return torch.zeros(p.shape, dtype=getattr(torch, mdt),
                           device=p.device)

    def init(params: Params) -> OptState:
        device = leaves(params)[0].device
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(_zero_moment, params),
            nu=tree_map(_zero_moment, params),
        )

    def _load(m, shape, *, second: bool = False) -> torch.Tensor:
        if mdt == "int8":
            return _dequantize(m, shape, sqrt_domain=second)
        return m.to(_F32)

    def _store(m: torch.Tensor, *, second: bool = False):
        if mdt == "int8":
            return _quantize(m, sqrt_domain=second)
        return m.to(getattr(torch, mdt))

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params
               ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
        step = state.step + 1
        gnorm = torch.sqrt(sum(torch.sum(g.to(_F32) ** 2)
                               for g in leaves(grads)))
        clip = torch.clamp(ocfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
        lr = sched(step)
        b1, b2 = ocfg.b1, ocfg.b2
        stepf = step.to(_F32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=_F32, device=step.device),
                            stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=_F32, device=step.device),
                            stepf)

        def upd(p, g, mu_q, nu_q):
            g = g.to(_F32) * clip
            mu = b1 * _load(mu_q, p.shape) + (1 - b1) * g
            nu = b2 * _load(nu_q, p.shape, second=True) + (1 - b2) * g * g
            mhat = mu / bc1
            nhat = nu / bc2
            delta = mhat / (torch.sqrt(nhat) + ocfg.eps)
            decay = ocfg.weight_decay if p.ndim >= 2 else 0.0
            newp = p.to(_F32) * (1 - lr * decay) - lr * delta
            return (newp.to(p.dtype), _store(mu),
                    _store(nu, second=True))

        out = tree_map(upd, params, grads, state.mu, state.nu)
        new_params = tree_map(lambda _p, t: t[0], params, out)
        new_mu = tree_map(lambda _p, t: t[1], params, out)
        new_nu = tree_map(lambda _p, t: t[2], params, out)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_params, OptState(step, new_mu, new_nu), metrics

    return init, update
