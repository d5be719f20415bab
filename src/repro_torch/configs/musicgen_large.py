"""musicgen-large [audio]: decoder-only over EnCodec tokens, K=4 codebooks
(delay pattern applied by the data pipeline); GELU FFN.
[arXiv:2306.05284; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp="gelu",
    norm="layernorm",
    n_codebooks=4,
    rope_theta=10_000.0,
    notes="audio frontend stub: EnCodec code streams arrive precomputed",
)
