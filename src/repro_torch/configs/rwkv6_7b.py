"""rwkv6-7b [ssm] "Finch": attention-free, data-dependent decay.
32L d_model=4096 d_ff=14336 vocab=65536, head_size 64 (64 heads).
[arXiv:2404.05892; hf]"""
from ..models import ModelConfig, RWKVCfg

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
    rwkv=RWKVCfg(head_size=64, w_lora=64, gate_lora=128),
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=224, vocab_size=512, act_dtype="float32",
    rwkv=RWKVCfg(head_size=16, w_lora=8, gate_lora=16),
)
