"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + 64 routed experts
top-6 + 2 shared experts.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400. [arXiv:2405.04434]

``CONFIG`` / ``SMOKE`` are JAX's, field for field (the registry's
``deepseek-v2-lite-16b``): every layer MoE, the top-6 gates renormalised,
plain RoPE. ``PUBLISHED`` is the model as published
(https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json):
layer 0 has a dense SwiGLU of width 10,944 (``first_k_dense_replace`` 1),
the gates are the softmax's top 6 unnormalised (``norm_topk_prob`` false,
``routed_scaling_factor`` 1), and the 64 rotary dims take YaRN (factor 40
over 4,096 positions, ``beta_fast`` 32, ``beta_slow`` 1, ``mscale`` =
``mscale_all_dim`` = 0.707), whose ``mscale`` squared multiplies the
softmax scale. 15.71 B parameters, 2.45 B active a token.

DeepSeek's checkpoint stores each head's rotary columns (``q_pe``,
``k_pe``) interleaved, pairs (2i, 2i + 1); the port rotates the half
pairs (i, i + 32). The two are the same model up to a fixed permutation
of the rotary output columns of ``wq`` and ``w_kpe``, which a converted
checkpoint would apply once.
"""

from repro_torch.models.config import (
    DeepSeekV2Config,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    YarnConfig,
)

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

PUBLISHED = DeepSeekV2Config(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    mla=CONFIG.mla,
    moe=CONFIG.moe,
    dense_layers=1,
    dense_d_ff=10_944,
    norm_topk=False,
    yarn=YarnConfig(factor=40.0, original_max_position=4096, beta_fast=32.0,
                    beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707),
)

# A dense layer 0 and two MoE layers at small widths; YaRN over 8 rotary
# dims keeps all three of its bands (the correction range is [1, 3]).
PUBLISHED_SMOKE = PUBLISHED.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=32, vocab_size=256, dense_d_ff=96,
    mla=SMOKE.mla,
    moe=MoEConfig(num_experts=8, top_k=3, d_expert=32, num_shared=2),
)
