"""The paper's own architecture slot: a ~100M-param decoder LM over radar
reflectivity tokens (the end-to-end training example's model).

llama-style: RMSNorm + SwiGLU + RoPE, GQA 12H/4KV, vocab = 256 dBZ bins.
~103M params at 12L × d768 — sized for the assignment's "train a ~100M
model for a few hundred steps" example on CPU/one host.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="radar-lm-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=3072,
    vocab_size=256,
    rope_theta=10_000.0,
    sub_quadratic=False,
    notes="paper-native radar-token LM (examples/train_lm.py)",
)
