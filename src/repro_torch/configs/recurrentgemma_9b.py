"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 pattern.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window 2048.
[arXiv:2402.19427]
"""

from repro_torch.models.config import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    norm="rmsnorm",
    activation="swiglu",
    attention="local",
    window=2048,
    rope_theta=10_000.0,
    tie_embeddings=True,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), lru_width=4096,
                        window=2048, d_conv=4),
)

SMOKE = CONFIG.replace(
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    window=8,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), lru_width=64,
                        window=8, d_conv=4),
    remat="none",
)
