"""Architecture registry: ``--arch <id>`` resolves here."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

#: arch id -> module name
_MODULES: Dict[str, str] = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "yi-6b": "yi_6b",
    "gemma3-27b": "gemma3_27b",
    "qwen2.5-3b": "qwen2_5_3b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _mod(arch).REDUCED
