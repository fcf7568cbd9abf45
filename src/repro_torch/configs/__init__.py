"""Architecture configs of the port (``--arch <id>``), the reference's ids.

Only ``rwkv6-7b`` is ported; the other ids raise ``NotImplementedError``
until ROADMAP queue 1, 'Model zoo and training' ports their families.
"""
from __future__ import annotations

import importlib

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
_PORTED = {"rwkv6-7b": "rwkv6_7b"}


def _mod(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    if arch not in _PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: ROADMAP queue 1, 'Model zoo and training' "
            f"(ported: {list(_PORTED)})"
        )
    return importlib.import_module(f".{_PORTED[arch]}", __package__)


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke(arch: str):
    return _mod(arch).SMOKE
