"""Registry mapping ``--arch`` ids to ModelConfigs (mirrors
``repro.configs.registry``).

The port runs the dense and MoE families with GQA or MLA attention, the
ssm family (RWKV-6) and the hybrid one (Mamba2 with a shared attention
block); the VLM and audio ids are known (it is the reference's list) but
raise ``NotImplementedError`` naming the ROADMAP item that will port their
family.  :func:`all_configs` lists every id, as the reference's does.
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

PORTED_ARCH_IDS = ("zamba2-1.2b", "rwkv6-3b", "yi-6b",
                   "deepseek-v2-lite-16b", "smollm-135m", "mixtral-8x7b",
                   "minicpm3-4b", "phi3-mini-3.8b", "gfl-logreg")

# what each unported id waits for (ROADMAP, queue 1, slice 7)
_PENDING = {
    "llava-next-mistral-7b": "item 19d (VLM inputs)",
    "whisper-tiny": "item 19d (audio encoder-decoder)",
}


def _module_name(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: ROADMAP {_PENDING[arch_id]}")
    return importlib.import_module(_module_name(arch_id)).CONFIG


def all_configs() -> dict:
    """{arch id: ModelConfig} for every model id of the reference (the
    paper's ``gfl-logreg`` left out, as there); an id not ported yet maps
    to None — :func:`get_config` raises for it."""
    return {a: get_config(a) if a in PORTED_ARCH_IDS else None
            for a in ARCH_IDS if a != "gfl-logreg"}
