"""Architecture registry: one module per assigned architecture (the
reference package's registry, copied)."""

from typing import Dict

from .base import ModelConfig, ParallelConfig, ShapeConfig, SHAPES
from .deepseek_67b import CONFIG as deepseek_67b
from .deepseek_v2_lite_16b import CONFIG as deepseek_v2_lite_16b
from .llama3p2_1b import CONFIG as llama3p2_1b
from .llama4_maverick_400b import CONFIG as llama4_maverick_400b
from .musicgen_large import CONFIG as musicgen_large
from .qwen1p5_4b import CONFIG as qwen1p5_4b
from .radar_lm_100m import CONFIG as radar_lm_100m
from .qwen2_vl_7b import CONFIG as qwen2_vl_7b
from .stablelm_3b import CONFIG as stablelm_3b
from .xlstm_1p3b import CONFIG as xlstm_1p3b
from .zamba2_1p2b import CONFIG as zamba2_1p2b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        zamba2_1p2b,
        xlstm_1p3b,
        qwen2_vl_7b,
        llama4_maverick_400b,
        deepseek_v2_lite_16b,
        deepseek_67b,
        qwen1p5_4b,
        stablelm_3b,
        llama3p2_1b,
        musicgen_large,
    ]
}

# the paper's own architecture (not part of the 40 assigned dry-run cells)
EXTRA_ARCHS: Dict[str, ModelConfig] = {radar_lm_100m.name: radar_lm_100m}


def get_any_config(name: str) -> ModelConfig:
    """Look up a config across production and extra architectures."""
    if name in ARCHS:
        return ARCHS[name]
    if name in EXTRA_ARCHS:
        return EXTRA_ARCHS[name]
    raise KeyError(
        f"unknown arch {name!r}; available: {sorted(ARCHS) + sorted(EXTRA_ARCHS)}")


def get_config(name: str) -> ModelConfig:
    """Look up a production architecture config by name."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "EXTRA_ARCHS", "SHAPES", "ModelConfig", "ParallelConfig",
           "ShapeConfig", "get_any_config", "get_config"]
