"""whisper-tiny [audio]: encoder-decoder, conv frontend stubbed
(input_specs supplies precomputed frame embeddings).

4L d_model=384 6H d_ff=1536 vocab=51865. [arXiv:2212.04356]
"""

from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,  # decoder layers; encoder in encdec config
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    norm="layernorm",
    activation="gelu",
    qkv_bias=True,
    rope_theta=0.0,  # absolute positions (sinusoidal enc / learned dec)
    tie_embeddings=True,
    encdec=EncDecConfig(enc_layers=4, max_source_positions=1500),
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    encdec=EncDecConfig(enc_layers=2, max_source_positions=64),
    remat="none",
)
