"""granite-34b [dense]: llama-arch code model, MQA (kv=1).

88L d_model=6144 48H d_ff=24576 vocab=49152. [arXiv:2405.04324]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256, remat="none",
)
