"""llama4-maverick-400b-a17b [moe]: interleaved MoE, 128 routed top-1 + 1
shared expert.

Assignment lists 48L/128e/top-1 (unverified).  Every-layer MoE at
d_ff=8192 would give ~780B; to match the published 400B-total/17B-active
we interleave (every 2nd layer MoE, dense layers d_ff=16384) — recorded in
DESIGN.md. [hf:meta-llama/Llama-4; unverified]
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    d_head=128,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1,
                  interleave=2, dense_d_ff=16384),
    notes="interleaved MoE to hit 400B/17B (assignment numbers unverified)",
)
