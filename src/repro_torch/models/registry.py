"""Architecture registry: --arch <id> -> ModelConfig."""
from __future__ import annotations

import importlib
from typing import Dict

from ..configs.base import ModelConfig

ARCH_IDS = (
    "rwkv6_7b",
    "gemma_7b",
    "granite_3_8b",
    "gemma3_27b",
    "glm4_9b",
    "kimi_k2_1t_a32b",
    "phi35_moe_42b_a6_6b",
    "llava_next_34b",
    "hymba_1_5b",
    "whisper_large_v3",
)

# external ids (as assigned) -> module names
ALIASES = {
    "rwkv6-7b": "rwkv6_7b",
    "gemma-7b": "gemma_7b",
    "granite-3-8b": "granite_3_8b",
    "gemma3-27b": "gemma3_27b",
    "glm4-9b": "glm4_9b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a6_6b",
    "llava-next-34b": "llava_next_34b",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-large-v3": "whisper_large_v3",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
