"""Batch construction: concrete tensors (training) and shape stand-ins.

The port of the reference package's ``data/batches.py``.  ``make_batch``
draws from numpy's ``default_rng(seed)`` exactly as the reference does,
so both packages build the same batch from the same seed; the modality
frontends of the vlm and audio families are stubs there and here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..radar._device import DeviceLike, resolve_device
from ..train.step import TensorSpec


def _tensors(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0, *,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Concrete random batch for training, on ``device`` (``None`` means
    ``"cuda"``)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return _tensors({
            "embeds": rng.normal(size=(batch, seq, cfg.d_model))
            .astype("float32"),
            "positions3": np.broadcast_to(np.arange(seq, dtype="int32"),
                                          (batch, 3, seq)).copy(),
            "targets": rng.integers(0, cfg.vocab_size, size=(batch, seq),
                                    dtype="int32"),
        }, device)
    if cfg.n_codebooks > 1:
        codes = rng.integers(0, cfg.vocab_size,
                             size=(batch, cfg.n_codebooks, seq), dtype="int32")
        return _tensors({"codes": codes,
                         "targets": np.roll(codes, -1, axis=-1)}, device)
    tokens = rng.integers(0, cfg.vocab_size, size=(batch, seq), dtype="int32")
    return _tensors({"tokens": tokens,
                     "targets": np.roll(tokens, -1, axis=-1)}, device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """:class:`TensorSpec` stand-ins for every model input of a cell.

    ``train``/``prefill`` describe the full sequence; ``decode`` describes
    one new token (the KV cache specs come from the serve engine).
    """
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    f32, i32 = torch.float32, torch.int32
    if cfg.family == "vlm":
        batch = {"embeds": TensorSpec((B, S, cfg.d_model), f32),
                 "positions3": TensorSpec((B, 3, S), i32)}
        if shape.kind == "train":
            batch["targets"] = TensorSpec((B, S), i32)
        return batch
    if cfg.n_codebooks > 1:
        batch = {"codes": TensorSpec((B, cfg.n_codebooks, S), i32)}
        if shape.kind == "train":
            batch["targets"] = TensorSpec((B, cfg.n_codebooks, S), i32)
        return batch
    batch = {"tokens": TensorSpec((B, S), i32)}
    if shape.kind == "train":
        batch["targets"] = TensorSpec((B, S), i32)
    return batch
