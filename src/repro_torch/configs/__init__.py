"""Config registry: ``--arch <id>`` resolution, the port's counterpart of
:mod:`repro.configs`.

The registry lists every arch id the reference has. ``get_config`` returns
the published configuration of an arch the port can run and raises
``NotImplementedError`` naming the ROADMAP item for the others;
``get_reduced`` returns the smoke-test-sized family twin.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, _MISSING, reduced

# Every arch id of the reference, in its order. An arch the port runs maps
# to its config module; the others to the reason they wait.
_REGISTRY: dict[str, tuple[str | None, str | None]] = {
    "whisper-tiny": (None, _MISSING["encdec"]),
    "qwen1.5-110b": (None, _MISSING["sp"]),
    "stablelm-1.6b": (None, _MISSING["sp"]),
    "qwen2-7b": (None, _MISSING["sp"]),
    "llama3.2-3b": (None, _MISSING["sp"]),
    "mixtral-8x7b": (None, _MISSING["moe"]),
    "arctic-480b": (None, _MISSING["moe"]),
    "recurrentgemma-9b": ("recurrentgemma_9b", None),
    "rwkv6-7b": (None, _MISSING["rwkv"]),
    "llava-next-mistral-7b": (None, _MISSING["vlm"]),
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}"
        )
    module, waits_for = _REGISTRY[arch_id]
    if module is None:
        raise NotImplementedError(f"{arch_id}: {waits_for}")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch_id), **overrides)


__all__ = ["ARCH_IDS", "get_config", "get_reduced"]
