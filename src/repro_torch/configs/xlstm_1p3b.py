"""xlstm-1.3b [ssm]: mLSTM matrix-memory blocks + sLSTM every 8th (7:1).

d_ff=0 in the assignment: projection factors live inside the blocks
(mLSTM pf=1.5 block-diagonal qkv, sLSTM pf=4/3), matching ~1.3B total.
[arXiv:2405.04517; unverified]
"""

from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    mixer="mlstm",
    xlstm=XLSTMConfig(slstm_every=8, mlstm_proj_factor=1.5),
    sub_quadratic=True,
    notes="recurrent state decode; long_500k eligible",
)
