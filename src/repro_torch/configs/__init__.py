"""Config registry: ``--arch <id>`` resolution, the port's counterpart of
:mod:`repro.configs`.

The registry lists every arch id the reference has, each with its
config module; ``get_config`` returns the published configuration and
``get_reduced`` the smoke-test-sized family twin.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

# arch id → module name, in the reference's order
_REGISTRY = {
    "whisper-tiny": "whisper_tiny",
    "qwen1.5-110b": "qwen1_5_110b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen2-7b": "qwen2_7b",
    "llama3.2-3b": "llama3_2_3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "arctic-480b": "arctic_480b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-7b": "rwkv6_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}"
        )
    return importlib.import_module(
        f"repro_torch.configs.{_REGISTRY[arch_id]}").CONFIG


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch_id), **overrides)


__all__ = ["ARCH_IDS", "get_config", "get_reduced"]
