"""The LM stack: layers, GQA attention, the Mamba-2 mixer, blocks, the
top-level model, and the converter from the reference package's
parameters."""

from . import attention, convert, layers, model, ssm, transformer

__all__ = ["attention", "convert", "layers", "model", "ssm", "transformer"]
