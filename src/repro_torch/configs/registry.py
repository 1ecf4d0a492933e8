"""Registry mapping ``--arch`` ids to ModelConfigs (mirrors
``repro.configs.registry``): every id of the reference is ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = [
    "zamba2-1.2b",
    "rwkv6-3b",
    "yi-6b",
    "llava-next-mistral-7b",
    "whisper-tiny",
    "deepseek-v2-lite-16b",
    "smollm-135m",
    "mixtral-8x7b",
    "minicpm3-4b",
    "phi3-mini-3.8b",
    # the paper's own experiment model
    "gfl-logreg",
]

def _module_name(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_module_name(arch_id)).CONFIG


def all_configs() -> dict:
    """{arch id: ModelConfig} for every model id of the reference (the
    paper's ``gfl-logreg`` left out, as there)."""
    return {a: get_config(a) for a in ARCH_IDS if a != "gfl-logreg"}
