"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.

48L d_model=1024, vocab=50280, ssm_state=128. [arXiv:2405.21060]
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=32,  # d_inner / head_dim = 2048 / 64
    num_kv_heads=32,
    d_ff=0,  # attention-free, no separate channel mixer
    vocab_size=50_280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)

SMOKE = CONFIG.replace(
    num_layers=3,
    d_model=64,
    num_heads=8,
    num_kv_heads=8,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
    remat="none",
)
