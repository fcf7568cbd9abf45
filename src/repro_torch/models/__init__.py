"""Model zoo of the port (``repro.models``' counterpart): configuration,
parameter declarations, shared layers, attention (GQA and MLA), the MoE
block, and every family of the reference: dense (GQA transformer), vlm
(pixtral's backbone), moe (deepseek-v3, kimi-k2), ssm (RWKV-6), hybrid
(recurrentgemma, ``griffin.py``) and audio (whisper, ``whisper.py``)."""
from .config import (
    EncDecCfg,
    GriffinCfg,
    MLACfg,
    MoECfg,
    ModelConfig,
    RWKVCfg,
)
from .registry import ModelAPI, get_api, make_batch

__all__ = [
    "EncDecCfg",
    "GriffinCfg",
    "MLACfg",
    "MoECfg",
    "ModelConfig",
    "RWKVCfg",
    "ModelAPI",
    "get_api",
    "make_batch",
]
