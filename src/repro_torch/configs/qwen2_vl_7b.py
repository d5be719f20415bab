"""qwen2-vl-7b [vlm]: M-RoPE decoder; vision frontend stubbed.

input_specs() supplies precomputed patch/text embeddings plus (t, h, w)
position triplets; the backbone matches Qwen2-7B. [arXiv:2409.12191; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    notes="M-RoPE; modality frontend is a stub (precomputed embeddings)",
)
