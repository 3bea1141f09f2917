"""Architecture registry: the 10 assigned configs (+ reduced smoke variants).

``get_config(name)`` returns the exact published dims; ``get_smoke(name)``
returns a structurally identical but tiny variant for CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import SHAPES, LONG_CONTEXT_OK, ModelConfig, ShapeSpec, cell_is_runnable

ARCH_NAMES = [
    "phi-3-vision-4.2b",
    "gemma3-4b",
    "qwen3-8b",
    "qwen2-1.5b",
    "gemma2-9b",
    "whisper-small",
    "mamba2-1.3b",
    "deepseek-moe-16b",
    "granite-moe-3b-a800m",
    "hymba-1.5b",
]

_MODULES = {
    "phi-3-vision-4.2b": "phi3_vision",
    "gemma3-4b": "gemma3_4b",
    "qwen3-8b": "qwen3_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma2-9b": "gemma2_9b",
    "whisper-small": "whisper_small",
    "mamba2-1.3b": "mamba2_1_3b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "hymba-1.5b": "hymba_1_5b",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SMOKE


def all_configs() -> dict:
    return {n: get_config(n) for n in ARCH_NAMES}
