"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + 64 routed experts
top-6 + 2 shared experts.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400. [arXiv:2405.04434]
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    mla=MLAConfig(kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  capacity_factor=1.25),
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=64, vocab_size=256,
    mla=MLAConfig(kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=64, num_shared=1,
                  capacity_factor=2.0),
    remat="none",
)
