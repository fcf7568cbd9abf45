"""qwen2-72b [dense]: GQA with QKV bias.
80L d_model=8192 64H (kv=8, head_dim 128) d_ff=29568 vocab=152064.
[arXiv:2407.10671; hf]"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, qkv_bias=True, act_dtype="float32",
)
