"""Model zoo of the port (``repro.models``' counterpart): configuration,
parameter declarations, shared layers, attention (GQA and MLA), the MoE
block, and the dense (GQA transformer), moe (deepseek-v3, kimi-k2) and ssm
(RWKV-6) families.  The other families come with the
ROADMAP queue 1 items that :data:`.config.FAMILY_ITEMS` names."""
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
