"""qwen3-moe-235b-a22b [moe]: 128 experts, top-8, qk_norm GQA.

94L d_model=4096 64H (kv=4) d_ff(expert)=1536 vocab=151936.
[hf:Qwen/Qwen3-30B-A3B]
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # per-expert hidden
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536, num_shared=0,
                  capacity_factor=1.25),
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=96, num_shared=0,
                  capacity_factor=2.0),
    remat="none",
)
