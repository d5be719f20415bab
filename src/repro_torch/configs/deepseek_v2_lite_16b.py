"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + fine-grained MoE.

2 shared + 64 routed experts top-6, first layer dense (d_ff=10944),
expert d_ff=1408. [arXiv:2405.04434; hf]
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_rope_head_dim=64,
                  qk_nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  interleave=1, first_dense=1, dense_d_ff=10944),
    notes="MLA latent cache = 512+64 per token (shared across heads)",
)
