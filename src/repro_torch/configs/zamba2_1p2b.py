"""zamba2-1.2b [hybrid]: Mamba2 backbone + weight-shared attention block.

38 Mamba2 blocks (d_state=64) with the Zamba shared attention+MLP block
applied every 6 blocks (weights reused; input concat(h, embedding)).
[arXiv:2411.15242; hf]
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    d_head=64,
    mixer="mamba2",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, attn_every=6),
    rope_theta=10_000.0,
    sub_quadratic=True,
    notes="hybrid Mamba2 + shared attn; long_500k eligible",
)
