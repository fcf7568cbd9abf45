"""Architecture configs of the port (``--arch <id>``), the reference's ids.

The dense family (``qwen3-1.7b``, ``minitron-8b``, ``qwen2-72b``,
``qwen1.5-110b``) and ``rwkv6-7b`` are ported; each other id raises
``NotImplementedError`` naming the ROADMAP queue 1 item that ports its
family.
"""
from __future__ import annotations

import importlib

from ..models.config import FAMILY_ITEMS, not_ported

# the reference's arch ids, in its order
ARCH_IDS = [
    "pixtral-12b",
    "deepseek-v3-671b",
    "kimi-k2-1t-a32b",
    "qwen3-1.7b",
    "minitron-8b",
    "qwen2-72b",
    "qwen1.5-110b",
    "rwkv6-7b",
    "recurrentgemma-2b",
    "whisper-medium",
]
_PORTED = {
    "qwen3-1.7b": "qwen3_1p7b",
    "minitron-8b": "minitron_8b",
    "qwen2-72b": "qwen2_72b",
    "qwen1.5-110b": "qwen1p5_110b",
    "rwkv6-7b": "rwkv6_7b",
}
_WAITING = {  # arch -> its family
    "pixtral-12b": "vlm",
    "deepseek-v3-671b": "moe",
    "kimi-k2-1t-a32b": "moe",
    "recurrentgemma-2b": "hybrid",
    "whisper-medium": "audio",
}


def _mod(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    if arch not in _PORTED:
        raise not_ported(f"{arch} ({_WAITING[arch]})", FAMILY_ITEMS[_WAITING[arch]])
    return importlib.import_module(f".{_PORTED[arch]}", __package__)


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke(arch: str):
    return _mod(arch).SMOKE
