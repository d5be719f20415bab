"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions."""

from . import ops, ref

__all__ = ["ops", "ref"]
