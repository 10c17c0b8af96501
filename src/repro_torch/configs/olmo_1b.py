"""olmo-1b [dense]: non-parametric LayerNorm, tied embeddings.

16L d_model=2048 16H d_ff=8192 vocab=50304. [arXiv:2402.00838]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50_304,
    norm="nonparam_ln",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, remat="none",
)
