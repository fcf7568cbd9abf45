"""Model zoo of the port (``repro.models``' counterpart): configuration,
parameter declarations, shared layers and the RWKV-6 family.  The other
families come with ROADMAP queue 1, "Model zoo and training"."""
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
