"""qwen1.5-4b [dense]: GQA kv=20 (MHA-equal), QKV bias.

40L d_model=2560 20H d_ff=6912 vocab=151936. [hf:Qwen/Qwen1.5-0.5B]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1e6,
    # 20 heads on a 16-way TP axis: batch-over-model sharding (see
    # ModelConfig.shard_batch_over_model and EXPERIMENTS.md §Perf T3)
    shard_batch_over_model=True,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, remat="none",
)
