"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 2 recurrent : 1 attn.
26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 (GeGLU) vocab=256000,
lru_width=2560, window=2048.  [arXiv:2402.19427; hf]"""
from ..models import GriffinCfg, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    tie_embeddings=True,
    griffin=GriffinCfg(lru_width=2560, conv_width=4, window=2048, pattern=("rec", "rec", "attn")),
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=5,
    d_model=60,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    act_dtype="float32",
    tie_embeddings=True,
    griffin=GriffinCfg(lru_width=60, conv_width=4, window=8, pattern=("rec", "rec", "attn")),
)
