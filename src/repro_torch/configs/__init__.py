"""Architecture configs of the port (``--arch <id>``), the reference's ids
and configs, field for field: the dense family (``qwen3-1.7b``,
``minitron-8b``, ``qwen2-72b``, ``qwen1.5-110b``), the MoE family
(``deepseek-v3-671b`` with MLA, ``kimi-k2-1t-a32b``), ``rwkv6-7b`` (ssm),
``recurrentgemma-2b`` (hybrid), ``whisper-medium`` (audio) and
``pixtral-12b`` (vlm).
"""
from __future__ import annotations

import importlib

_MODULES = {
    "pixtral-12b": "pixtral_12b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-1.7b": "qwen3_1p7b",
    "minitron-8b": "minitron_8b",
    "qwen2-72b": "qwen2_72b",
    "qwen1.5-110b": "qwen1p5_110b",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-medium": "whisper_medium",
}

ARCH_IDS = list(_MODULES)  # the reference's ids, in its order


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke(arch: str):
    return _mod(arch).SMOKE
