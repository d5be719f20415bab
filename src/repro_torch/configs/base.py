"""Config dataclasses: model architecture, shapes, parallelism, training.

This package's own copy of the reference package's ``configs/base.py``
(the port imports nothing of it).  Every architecture is a
:class:`ModelConfig` instance in its own module under
``repro_torch.configs``; shape suites are :class:`ShapeConfig`.  Configs
are plain frozen dataclasses, so they hash and serialize as they are.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block hyperparameters."""
    n_experts: int                  # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0               # shared (always-on) experts
    interleave: int = 1             # every `interleave`-th layer is MoE
    first_dense: int = 0            # first N layers stay dense
    dense_d_ff: int = 0             # d_ff for non-MoE layers when interleaved
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention hyperparameters."""
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 state-space block hyperparameters."""
    d_state: int = 64               # N
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    chunk: int = 128
    conv_width: int = 4
    attn_every: int = 0             # zamba2: shared attn block period


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block hyperparameters."""
    slstm_every: int = 8            # every 8th block is sLSTM (7:1 ratio)
    mlstm_proj_factor: float = 1.5
    slstm_proj_factor: float = 4.0 / 3.0
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    """Top-level architecture configuration for one model family."""
    name: str
    family: str                     # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    norm: str = "rmsnorm"           # rmsnorm|layernorm
    mlp: str = "swiglu"             # swiglu|gelu
    rope_theta: float = 500_000.0
    rope_fraction: float = 1.0      # stablelm: partial rotary
    qkv_bias: bool = False
    tie_embeddings: bool = False
    mrope: bool = False             # qwen2-vl 3-axis multimodal RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    n_codebooks: int = 1            # musicgen: EnCodec streams
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # which mixers appear: "attn" | "mla" | "mamba2" | "mlstm" | "slstm"
    mixer: str = "attn"
    logit_softcap: float = 0.0
    sub_quadratic: bool = False     # eligible for long_500k
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate total parameters (embeddings included once)."""
        from ..models.model import count_params  # local import, avoids cycle
        return count_params(self)

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family variant for CPU smoke tests."""
        small: Dict = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            d_head=32,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                dense_d_ff=128 if self.moe.dense_d_ff else 0,
            )
        if self.mla is not None:
            small["mla"] = MLAConfig(kv_lora_rank=32, qk_rope_head_dim=8,
                                     qk_nope_head_dim=16, v_head_dim=16)
            small["d_head"] = 0
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32,
                attn_every=3 if self.ssm.attn_every else 0,
            )
        if self.mrope:
            half = small["d_head"] // 2
            t = half // 4
            small["mrope_sections"] = (t, (half - t) // 2,
                                       half - t - (half - t) // 2)
        if self.xlstm is not None:
            small["xlstm"] = dataclasses.replace(self.xlstm, slstm_every=2,
                                                 chunk=32)
            small["n_layers"] = 4
        if self.ssm is not None and self.ssm.attn_every:
            small["n_layers"] = 6
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One workload shape point: sequence length, batch, and kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    """How a step is laid out on the mesh."""
    n_microbatches: int = 1
    remat: str = "block"            # none|block|dots
    param_dtype: str = "float32"    # master copy
    compute_dtype: str = "bfloat16"
    opt_moment_dtype: str = "float32"   # float32|bfloat16|int8
    scan_layers: bool = True        # False -> unrolled (dry-run cost analysis)
    shard_embed_vocab: bool = True
    fsdp_params: bool = True        # shard params over the data axis too
    kv_cache_dtype: str = "bfloat16"
