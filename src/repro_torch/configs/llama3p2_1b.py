"""llama3.2-1b [dense]: small llama3, GQA kv=8, tied embeddings.
[hf:meta-llama/Llama-3.2-1B; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    d_head=64,
    tie_embeddings=True,
    rope_theta=500_000.0,
)
