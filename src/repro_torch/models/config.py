"""Model configuration dataclasses covering all assigned families (port of
``repro/models/config.py``: the same fields and defaults, so every arch
file loads and compares field for field with JAX's)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims."""

    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) dims."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Griffin / RecurrentGemma: (rec, rec, attn) repeating pattern."""

    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    lru_width: Optional[int] = None  # defaults to d_model
    window: int = 2048
    d_conv: int = 4
    c_factor: float = 8.0  # RG-LRU gate exponent scale


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder; frontend is a stub (frame
    embeddings arrive precomputed)."""

    enc_layers: int = 4
    max_source_positions: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    attention: str = "full"  # full | local | knn
    window: int = 0
    knn_neighbors: int = 64
    # norms / activations / embeddings
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    activation: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 1e4
    mrope_sections: Optional[tuple[int, ...]] = None  # qwen2-vl
    tie_embeddings: bool = False
    # family extensions
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    # numerics / structure
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "full"  # none | full | dots
    q_chunk: int = 512
    logit_softcap: float = 0.0
    # Sharding policy: when num_heads doesn't divide the TP axis (e.g.
    # 20 heads on 16-way model), shard the batch over (data, model) for
    # the WHOLE model instead of head-sharding — avoids both replicated
    # attention and per-layer activation resharding (§Perf T3.2).
    shard_batch_over_model: bool = False

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM/hybrid/knn are O(1)/O(k) per
        decode step in sequence length at fixed state.)"""
        return self.family in ("ssm", "hybrid") or self.attention == "knn"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class YarnConfig:
    """YaRN's rotary scaling as DeepSeek's ``DeepseekV2YarnRotaryEmbedding``
    applies it (``rope_scaling`` of a published ``config.json``)."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config(ModelConfig):
    """A DeepSeek-V2 model as published, with what JAX's ``ModelConfig``
    has no field for (JAX's configs, which the port's registry copies
    field for field, make every layer MoE, renormalise the top-k gates
    and use plain RoPE): ``dense_layers`` leading layers with a dense
    SwiGLU of width ``dense_d_ff`` (``first_k_dense_replace``,
    ``intermediate_size``), the top-k gates kept as the softmax gives
    them when ``norm_topk`` is False (``norm_topk_prob``), and YaRN on
    the rotary dims with its softmax ``mscale`` (``rope_scaling``)."""

    dense_layers: int = 0
    dense_d_ff: int = 0
    norm_topk: bool = True
    yarn: Optional[YarnConfig] = None
