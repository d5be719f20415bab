"""The LM stack: layers, GQA attention, blocks, the top-level model, and the
converter from the reference package's parameters."""

from . import attention, convert, layers, model, transformer

__all__ = ["attention", "convert", "layers", "model", "transformer"]
