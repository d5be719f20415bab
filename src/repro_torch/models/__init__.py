"""The LM stack: layers, GQA and MLA attention, the Mamba-2 and xLSTM
mixers, the mixture-of-experts FFN, blocks, the top-level model, and the
converter from the reference package's parameters."""

from . import (attention, convert, layers, model, moe, ssm, transformer,
               xlstm)

__all__ = ["attention", "convert", "layers", "model", "moe", "ssm",
           "transformer", "xlstm"]
