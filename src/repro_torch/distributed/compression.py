"""Gradient compression for the scarce cross-pod links.

The port of the reference package's ``distributed/compression.py``.
Inside a node NVLink is fast; the ``pod`` axis crosses the slowest links,
so the cross-pod gradient all-reduce is the collective worth compressing.
Two codecs plus error feedback:

* ``bf16``  — 2× on-wire vs fp32, no state.
* ``int8``  — per-tensor absmax int8 (+fp32 scale), 4×; combined with
  **error feedback** (the quantization residual is carried to the next
  step) the training trajectory stays unbiased to first order.

The codecs are pure functions usable two ways:

1. inside the ``grad_transform`` hook of ``train.make_train_step``
   (:func:`make_crosspod_grad_transform`), or
2. explicitly via :func:`compressed_psum` over a process group or one
   dimension of a mesh.

``torch.round`` rounds half to even, as ``jnp.round`` does, and the
scale is formed in the reference's order (``max|x| / 127 + 1e-12`` in
float32), so both packages' codecs give the same bits.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Params = Any


def tree_map(fn, tree, *rest):
    # imported here: the training package imports the model, which
    # imports this package
    from ..train.tree import tree_map as _tree_map
    return _tree_map(fn, tree, *rest)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-tensor int8 quantization."""
    xf = x.to(torch.float32)
    # on the card a tensor divided by a Python number is multiplied by its
    # reciprocal (one more rounding); a tensor divisor keeps the division
    # exact, so the card's bits are the CPU's and the reference's
    scale = torch.amax(torch.abs(xf)) / torch.tensor(
        127.0, dtype=torch.float32, device=xf.device) + 1e-12
    return {"q": torch.clamp(torch.round(xf / scale), -127, 127)
            .to(torch.int8),
            "scale": scale}


def dequantize_int8(enc: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`."""
    return enc["q"].to(torch.float32) * enc["scale"]


def encode(x: torch.Tensor, codec: str):
    """Compress a tensor with the named gradient codec."""
    if codec == "int8":
        return quantize_int8(x)
    if codec == "bf16":
        return x.to(torch.bfloat16)
    if codec == "none":
        return x
    raise ValueError(f"unknown codec {codec!r}")


def decode(enc, codec: str) -> torch.Tensor:
    """Invert :func:`encode` back to a dense tensor."""
    if codec == "int8":
        return dequantize_int8(enc)
    return enc.to(torch.float32) if codec == "bf16" else enc


def wire_bytes(enc, codec: str) -> int:
    """Bytes an encoded tensor puts on the wire."""
    if codec == "int8":
        return enc["q"].numel() + 4
    return enc.numel() * enc.element_size()


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------

def init_error_feedback(params: Params) -> Params:
    """Zero error-feedback residuals shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_with_feedback(grads: Params, residual: Params, codec: str
                           ) -> Tuple[Params, Params]:
    """-> (decoded compressed grads, new residual).

    residual' = (g + residual) - decode(encode(g + residual))
    """
    if codec == "none":
        return grads, residual

    def one(g, r):
        corrected = g.to(torch.float32) + r
        dec = decode(encode(corrected, codec), codec)
        return dec, corrected - dec

    out = tree_map(one, grads, residual)
    comp = tree_map(lambda _g, t: t[0], grads, out)
    new_res = tree_map(lambda _g, t: t[1], grads, out)
    return comp, new_res


# ---------------------------------------------------------------------------
# explicit compressed collective
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, group))


def compressed_psum(x: torch.Tensor, group, codec: str = "int8"
                    ) -> torch.Tensor:
    """All-reduce with on-wire compression over ``group`` (a process
    group, or ``(mesh, dim)``).

    int8 payloads are summed in int32 (exact for <= 2^23 contributors),
    then rescaled by the max scale across members — the standard
    quantized-all-reduce trick that keeps a single reduction: the scale is
    an ``all_reduce(MAX)``, x is requantized to that shared scale, the
    ints are summed and the sum is rescaled.
    """
    if codec == "none":
        return _all_reduce(x, "sum", group)
    if codec == "bf16":
        return _all_reduce(x.to(torch.bfloat16), "sum", group) \
            .to(torch.float32)
    enc = quantize_int8(x)
    scale = _all_reduce(enc["scale"].reshape(1), "max", group).reshape(())
    # requantize against the shared scale so summed ints share units
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127) \
        .to(torch.int32)
    total = _all_reduce(q, "sum", group)
    return total.to(torch.float32) * scale


def make_crosspod_grad_transform(mesh, codec: str = "int8",
                                 mean: bool = True):
    """A ``grad_transform`` for ``train.make_train_step``.

    Compress-decompress at the pod boundary: the re-quantized values are
    what the pod-axis reduction transports; the decode happens after.
    ``None`` where the mesh has no ``pod`` axis or the codec is
    ``"none"``."""
    from .axes import axis_names
    if "pod" not in axis_names(mesh) or codec == "none":
        return None

    def transform(grads: Params) -> Params:
        return tree_map(lambda g: decode(encode(g, codec), codec).to(g.dtype),
                        grads)

    return transform
