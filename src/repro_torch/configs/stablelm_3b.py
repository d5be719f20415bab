"""stablelm-3b [dense]: LayerNorm + partial rotary (25%).
[hf:stabilityai/stablelm; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    rope_fraction=0.25,
    rope_theta=10_000.0,
)
