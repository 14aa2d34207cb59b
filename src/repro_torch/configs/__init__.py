"""Config registry: ``get_config(arch_id)`` / ``list_archs()``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, InputShape, INPUT_SHAPES  # noqa: F401

# arch-id -> module name (arch ids use dashes; modules use underscores)
_ARCHS = [
    "qwen3-32b",
    "stablelm-3b",
    "qwen3-moe-30b-a3b",
    "zamba2-7b",
    "qwen2-0.5b",
    "llava-next-mistral-7b",
    "qwen3-moe-235b-a22b",
    "seamless-m4t-medium",
    "xlstm-125m",
    "glm4-9b",
    # the paper's own model (Vicuna-7B, LLaMA architecture)
    "vicuna-7b",
]


def list_archs(include_paper_model: bool = True):
    return list(_ARCHS) if include_paper_model else [a for a in _ARCHS if a != "vicuna-7b"]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id.endswith("-smoke"):
        return get_config(arch_id[: -len("-smoke")]).reduced()
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {_ARCHS}")
    mod = importlib.import_module("repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
