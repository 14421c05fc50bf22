"""Architecture registry: the 10 assigned configs, as in
``repro/configs``.

``get_config(arch_id)`` returns the full-size ModelConfig; every config file
also exposes ``CONFIG``.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen2_72b",
    "minicpm_2b",
    "yi_6b",
    "granite_moe_1b_a400m",
    "whisper_base",
    "zamba2_1p2b",
    "xlstm_1p3b",
    "llama4_scout_17b_a16e",
    "qwen2_vl_72b",
    "stablelm_1p6b",
]

# CLI-facing ids (hyphenated, as assigned) -> module names
ALIASES: Dict[str, str] = {
    "qwen2-72b": "qwen2_72b",
    "minicpm-2b": "minicpm_2b",
    "yi-6b": "yi_6b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "whisper-base": "whisper_base",
    "zamba2-1.2b": "zamba2_1p2b",
    "xlstm-1.3b": "xlstm_1p3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "stablelm-1.6b": "stablelm_1p6b",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
