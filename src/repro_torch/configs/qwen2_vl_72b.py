"""qwen2-vl-72b [vlm]: M-RoPE (temporal/height/width sections), dynamic
resolution; vision frontend stubbed (input_specs supplies position ids).

80L d_model=8192 64H (kv=8) d_ff=29568 vocab=152064. [arXiv:2409.12191]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),  # sums to head_dim // 2
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, mrope_sections=(2, 3, 3), remat="none",
)
