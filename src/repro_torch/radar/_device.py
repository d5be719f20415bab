"""Where a product is computed: the GPU unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a GPU raises
    ``RuntimeError`` (no silent fall-back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this product runs on the GPU and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
