"""Registry mapping ``--arch`` ids to ModelConfigs (mirrors
``repro.configs.registry``).

The port runs the dense GQA family without MoE; every other id is known
(it is the reference's list) but raises ``NotImplementedError`` naming the
ROADMAP item that will port its family.
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

PORTED_ARCH_IDS = ("yi-6b", "smollm-135m", "phi3-mini-3.8b", "gfl-logreg")

# what each unported id waits for (ROADMAP, queue 1, slice 7)
_PENDING = {
    "mixtral-8x7b": "item 19a (MoE, models/moe.py)",
    "deepseek-v2-lite-16b": "items 19a-19b (MoE and MLA attention)",
    "minicpm3-4b": "item 19b (MLA attention)",
    "zamba2-1.2b": "item 19c (SSM / hybrid, models/ssm.py)",
    "rwkv6-3b": "item 19c (RWKV, models/rwkv.py)",
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
