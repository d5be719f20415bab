"""Block assembly: layer specs, layer groups, one block's forward pass.

The port of the reference package's ``models/transformer.py``: the
``attn`` (GQA) and ``mla`` (DeepSeek) attention mixers, zamba2's
``mamba2`` mixer with its weight-shared ``shared_attn`` block (attention +
MLP over ``concat(h, embedding)``), xLSTM's ``mlstm`` and ``slstm``
mixers, and the ``dense``, ``moe`` and ``none`` FFNs.  An architecture is
a list of ``(repeats, [LayerSpec, ...])`` groups (``layer_groups``, copied
as it is); the reference stacks a group's parameters over the repeat
dimension and runs it under ``lax.scan``, the port keeps one
``nn.ModuleDict`` per repeat in an ``nn.ModuleList`` and loops over them
in Python (no remat).  As in the reference, a group's parameters skip its
``shared_attn`` positions: the shared block's parameters live once,
outside the groups (:func:`init_shared_block`).  A ``moe`` FFN returns its
aux losses, which :func:`apply_unit` sums over the unit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import attention, moe as moe_mod, ssm, xlstm
from .layers import apply_mlp, apply_norm, dense_init, init_mlp, init_norm

Params = Any

@dataclass(frozen=True)
class LayerSpec:
    """Which mixer/FFN pair one layer instantiates."""
    mixer: str                    # attn|mla|mamba2|mlstm|slstm|shared_attn
    ffn: str = "dense"            # dense|moe|none
    d_ff: int = 0                 # 0 -> cfg.d_ff


def layer_groups(cfg: ModelConfig) -> List[Tuple[int, List[LayerSpec]]]:
    """The (repeats, unit) decomposition for each architecture family."""
    if cfg.mixer == "mamba2" and cfg.ssm and cfg.ssm.attn_every:
        period = cfg.ssm.attn_every
        unit = [LayerSpec("mamba2", "none")] * period + [
            LayerSpec("shared_attn", "none")
        ]
        n_units = cfg.n_layers // period
        rem = cfg.n_layers - n_units * period
        groups = [(n_units, unit)]
        if rem:
            groups.append((rem, [LayerSpec("mamba2", "none")]))
        return groups
    if cfg.mixer == "mamba2":
        return [(cfg.n_layers, [LayerSpec("mamba2", "none")])]
    if cfg.mixer == "mlstm":
        x = cfg.xlstm
        per = x.slstm_every
        unit = [LayerSpec("mlstm", "none")] * (per - 1) + [
            LayerSpec("slstm", "none")
        ]
        return [(cfg.n_layers // per, unit)]
    mixer = "mla" if cfg.mla is not None else "attn"
    if cfg.moe is not None:
        m = cfg.moe
        groups: List[Tuple[int, List[LayerSpec]]] = []
        if m.first_dense:
            groups.append(
                (m.first_dense,
                 [LayerSpec(mixer, "dense", m.dense_d_ff or cfg.d_ff)])
            )
        remaining = cfg.n_layers - m.first_dense
        if m.interleave > 1:
            unit = [LayerSpec(mixer, "dense", m.dense_d_ff or cfg.d_ff)] * (
                m.interleave - 1
            ) + [LayerSpec(mixer, "moe")]
            groups.append((remaining // m.interleave, unit))
        else:
            groups.append((remaining, [LayerSpec(mixer, "moe")]))
        return groups
    return [(cfg.n_layers, [LayerSpec(mixer, "dense")])]


# ---------------------------------------------------------------------------
# per-spec init / apply
# ---------------------------------------------------------------------------

# each mixer's initializer (zamba2's shared block lives outside the groups)
_MIXERS = {"attn": attention.init_attn, "mla": attention.init_mla,
           "mamba2": ssm.init_mamba2, "mlstm": xlstm.init_mlstm,
           "slstm": xlstm.init_slstm}


def init_layer(cfg: ModelConfig, spec: LayerSpec, gen, dtype,
               device) -> nn.ModuleDict:
    """One layer's parameters: ``mixer``, ``norm1``, ``ffn``, ``norm2``."""
    if spec.mixer not in _MIXERS:
        raise ValueError(spec.mixer)
    mixer = _MIXERS[spec.mixer](cfg, gen, dtype, device)
    p = nn.ModuleDict({
        "mixer": mixer,
        "norm1": init_norm(cfg, cfg.d_model, dtype, device),
    })
    if spec.ffn == "dense":
        p["ffn"] = init_mlp(cfg, gen, cfg.d_model, spec.d_ff or cfg.d_ff,
                            dtype, device)
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype, device)
    elif spec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(cfg, gen, dtype, device)
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype, device)
    return p


def apply_layer(
    cfg: ModelConfig,
    spec: LayerSpec,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    attn_impl: str = "blocked",
    slstm_cost_proxy: bool = False,
    emb0: Optional[torch.Tensor] = None,
    moe_dropless: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Optional[Dict]]:
    """One block: pre-norm mixer + residual (+ pre-norm FFN + residual).
    ``attn_impl="kernel"`` (the reference's ``"pallas"``) also sends a
    ``mamba2`` mixer to its kernel; any other impl sends it to the plain
    chunked SSD, as in the reference.  The ``moe`` FFN dispatches densely
    with ``moe_dropless``, else by sorted capacity dispatch."""
    aux: Dict[str, torch.Tensor] = {}
    h = apply_norm(cfg, p["norm1"], x)
    if spec.mixer == "shared_attn":
        # zamba2: shared weights, input concat(h, embedding stream)
        h = torch.cat([h, emb0.to(h.dtype)], dim=-1)
        h = h @ p["concat_proj"]
        o, new_cache = attention.apply_attn(
            cfg, p["mixer"], h, positions, cache=cache,
            cache_index=cache_index, impl=attn_impl,
        )
        o = o + apply_mlp(cfg, p["ffn_shared"], o)
    elif spec.mixer == "attn":
        o, new_cache = attention.apply_attn(
            cfg, p["mixer"], h, positions, cache=cache,
            cache_index=cache_index, impl=attn_impl,
        )
    elif spec.mixer == "mla":
        o, new_cache = attention.apply_mla(
            cfg, p["mixer"], h, positions, cache=cache,
            cache_index=cache_index, impl=attn_impl,
        )
    elif spec.mixer == "mamba2":
        o, new_cache = ssm.apply_mamba2(
            cfg, p["mixer"], h, state=cache,
            impl="kernel" if attn_impl == "kernel" else "chunked",
        )
    elif spec.mixer == "mlstm":
        o, new_cache = xlstm.apply_mlstm(cfg, p["mixer"], h, state=cache)
    elif spec.mixer == "slstm":
        o, new_cache = xlstm.apply_slstm(cfg, p["mixer"], h, state=cache,
                                         cost_proxy=slstm_cost_proxy)
    else:
        raise ValueError(spec.mixer)
    x = x + o
    if spec.ffn == "dense":
        h = apply_norm(cfg, p["norm2"], x)
        x = x + apply_mlp(dataclasses.replace(cfg, d_ff=spec.d_ff or cfg.d_ff),
                          p["ffn"], h)
    elif spec.ffn == "moe":
        h = apply_norm(cfg, p["norm2"], x)
        y, aux = moe_mod.apply_moe(cfg, p["ffn"], h, dropless=moe_dropless)
        x = x + y
    return x, aux, new_cache


class SharedBlock(nn.Module):
    """zamba2's shared block: ``norm1``, ``concat_proj`` (a leaf),
    ``mixer`` and ``ffn_shared``, read by name like a dict."""

    _NAMES = ("norm1", "concat_proj", "mixer", "ffn_shared")

    def __init__(self, norm1: nn.ParameterDict, concat_proj: nn.Parameter,
                 mixer: nn.ParameterDict, ffn_shared: nn.ParameterDict):
        super().__init__()
        self.norm1 = norm1
        self.concat_proj = concat_proj
        self.mixer = mixer
        self.ffn_shared = ffn_shared

    def __getitem__(self, key: str):
        if key not in self._NAMES:
            raise KeyError(key)
        return getattr(self, key)

    def __setitem__(self, key: str, value: nn.Parameter) -> None:
        if key != "concat_proj":
            raise KeyError(key)
        self.concat_proj = value

    def items(self):
        return [(k, self[k]) for k in self._NAMES]


def init_shared_block(cfg: ModelConfig, gen, dtype, device) -> SharedBlock:
    """zamba2's single shared attention+MLP block (+2D->D concat proj)."""
    return SharedBlock(
        norm1=init_norm(cfg, cfg.d_model, dtype, device),
        concat_proj=dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype,
                               device),
        mixer=attention.init_attn(cfg, gen, dtype, device),
        ffn_shared=init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype, device),
    )


def apply_unit(
    cfg: ModelConfig,
    unit: List[LayerSpec],
    unit_params: Params,
    shared_params: Optional[Params],
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    caches: Optional[List] = None,
    cache_index: Optional[int] = None,
    attn_impl: str = "blocked",
    slstm_cost_proxy: bool = False,
    emb0: Optional[torch.Tensor] = None,
    moe_dropless: bool = False,
):
    """Apply one repeat unit (its list of layers, ``layer_{i}`` each, the
    shared block woven in at its ``shared_attn`` positions)."""
    aux_total: Dict[str, torch.Tensor] = {}
    new_caches = [] if caches is not None else None
    for i, spec in enumerate(unit):
        p = (shared_params if spec.mixer == "shared_attn"
             else unit_params[f"layer_{i}"])
        x, aux, nc = apply_layer(
            cfg, spec, p, x, positions,
            cache=caches[i] if caches is not None else None,
            cache_index=cache_index, attn_impl=attn_impl,
            slstm_cost_proxy=slstm_cost_proxy, emb0=emb0,
            moe_dropless=moe_dropless,
        )
        for k, v in aux.items():
            aux_total[k] = aux_total.get(k, 0.0) + v
        if new_caches is not None:
            new_caches.append(nc)
    return x, aux_total, new_caches
