"""Parameters of the reference package's model, as numpy arrays, into the
port's :class:`~repro_torch.models.model.LMParams`.

The reference's tree is ``{"embed": {"tokens", "head"}, "groups": [
{"layer_i": {"mixer": {wq, wk, wv, wo}, "norm1", "ffn": {w_gate, w_up,
w_down}, "norm2"}} stacked over the group's repeats, ...], "final_norm"}``,
and for zamba2 a Mamba-2 ``mixer`` ({w_in, conv, A_log, D, dt_bias, w_out,
norm_scale}) and ``"shared": {"norm1", "concat_proj", "mixer", "ffn_shared"}``
(one block, not stacked).  The other mixers and FFNs carry their own
leaves under the same paths: an MLA ``mixer`` {wq, w_dkv, w_uk, w_uv, wo},
a MoE ``ffn`` {router, w_gate, w_up, w_down (the expert stacks, so a
stacked leaf has the repeat axis before the expert axis), shared_gate,
shared_up, shared_down}, an mLSTM ``mixer`` {w_up, conv, w_q, w_k, w_v,
w_gates, gate_bias, norm_scale, w_down} and an sLSTM ``mixer`` {w_x, r_h,
bias, norm_scale, w_up_gate, w_up, w_down}.
The port keeps the reference's leaf names and ``(d_in, d_out)`` layouts
(it multiplies by the kernels itself and uses no ``nn.Linear``), so each
leaf is copied as it is, and a stacked leaf is split along its leading
repeat axis into one layer each.  A leaf of the one tree that the other
lacks, or a shape that differs, raises ``ValueError``.  :func:`to_reference`
is the inverse, the port's parameters as the reference's stacked tree (the
layout training keeps and checkpoints store), and :func:`unstack` reads
such a tree back one layer per repeat, as the forward pass takes it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..radar._device import DeviceLike, resolve_device
from .model import LMParams, init_params

Path = Tuple[Any, ...]


def _flatten(tree: Any, prefix: Path = ()) -> Dict[Path, Any]:
    if isinstance(tree, Mapping):
        out: Dict[Path, Any] = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _port_leaves(params: LMParams):
    """``(reference path, repeat or None, owning dict, leaf name)`` of every
    parameter of ``params``."""
    for group in ("embed", "final_norm"):
        for name in params[group]:
            yield (group, name), None, params[group], name
    for gi, group in enumerate(params["groups"]):
        for r, unit in enumerate(group):
            for layer, p in unit.items():
                for part, sub in p.items():
                    for name in sub:
                        yield ("groups", gi, layer, part, name), r, sub, name
    if params.shared is not None:
        shared = params["shared"]
        for part, sub in shared.items():
            if isinstance(sub, nn.Parameter):
                yield ("shared", part), None, shared, part
            else:
                for name in sub:
                    yield ("shared", part, name), None, sub, name


def from_reference(cfg: ModelConfig, tree: Any, *,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> LMParams:
    """``tree`` (the reference's parameter pytree with numpy or torch
    leaves) as the port's parameters on ``device`` (``None`` means
    ``"cuda"``)."""
    dev = resolve_device(device)
    params = init_params(cfg, device="meta", dtype=dtype)
    leaves = _flatten(tree)
    seen = set()
    for path, rep, owner, name in _port_leaves(params):
        if path not in leaves:
            raise ValueError("reference parameters lack "
                             + "/".join(map(str, path)))
        seen.add(path)
        value = leaves[path]
        value = (value.detach().to("cpu", torch.float32).numpy()
                 if isinstance(value, torch.Tensor) else np.asarray(value))
        if rep is not None:
            reps = len(params["groups"][path[1]])
            if value.ndim == 0 or value.shape[0] != reps:
                raise ValueError(f"{'/'.join(map(str, path))}: reference "
                                 f"shape {value.shape}, expected {reps} "
                                 "stacked repeats")
            value = value[rep]
        want = tuple(owner[name].shape)
        if value.shape != want:
            raise ValueError(f"{'/'.join(map(str, path))}: reference shape "
                             f"{value.shape}, port shape {want}")
        owner[name] = nn.Parameter(
            torch.from_numpy(np.array(value, dtype=np.float32)).to(
                device=dev, dtype=dtype),
            requires_grad=False)
    extra = sorted("/".join(map(str, p)) for p in set(leaves) - seen)
    if extra:
        raise ValueError(f"reference parameters the port does not have: "
                         f"{extra}")
    return params


def to_reference(params: LMParams) -> Dict[str, Any]:
    """The inverse of :func:`from_reference`: ``params`` as the reference's
    pytree, plain nested dicts and lists of tensors on ``params``' device,
    every leaf under ``groups`` stacked over its group's repeats (a new
    tensor), the others the port's own tensors, detached."""
    tree: Dict[str, Any] = {}
    stacks: Dict[Path, list] = {}
    for path, rep, owner, name in _port_leaves(params):
        leaf = owner[name].detach()
        if rep is None:
            _set(tree, path, leaf)
        else:
            stacks.setdefault(path, []).append(leaf)
    for path, reps in stacks.items():
        _set(tree, path, torch.stack(reps))
    tree["groups"] = [tree["groups"][gi] for gi in sorted(tree["groups"])]
    return tree


def _set(tree: Dict[Any, Any], path: Path, value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def unstack(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A reference-layout tree (:func:`to_reference`) as the forward pass
    reads parameters: ``groups[g][r]`` one repeat's dict, each leaf a view
    ``leaf[r]`` of the stacked one, so gradients reach the stacked
    leaves."""
    out = {k: v for k, v in tree.items() if k != "groups"}
    groups = []
    for group in tree["groups"]:
        reps = next(iter(_flatten(group).values())).shape[0]
        groups.append([_take(group, r) for r in range(reps)])
    out["groups"] = groups
    return out


def _take(node: Any, r: int) -> Any:
    if isinstance(node, Mapping):
        return {k: _take(v, r) for k, v in node.items()}
    return node[r]
