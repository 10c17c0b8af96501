"""qwen3-32b [dense]: qk_norm, GQA kv=8.

64L d_model=5120 64H d_ff=25600 vocab=151936. [hf:Qwen/Qwen3-8B]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, remat="none",
)
