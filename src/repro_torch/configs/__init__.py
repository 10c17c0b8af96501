"""Architecture registry: the 10 assigned archs (port of ``repro/configs``).

``get_config(name)`` / ``get_smoke(name)`` select by --arch id.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# arch id -> module path (one file per assigned architecture)
_ARCH_MODULES = {
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
}

ARCH_IDS = tuple(_ARCH_MODULES)

# (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[name])
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[name])
    return mod.SMOKE


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Is (arch, shape) runnable? long_500k needs sub-quadratic attention
    (DESIGN.md §Arch-applicability)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode is quadratic — skipped (see DESIGN.md); opt-in via attention='knn'"
    return True, ""
