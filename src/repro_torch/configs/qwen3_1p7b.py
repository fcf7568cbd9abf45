"""qwen3-1.7b [dense]: qk_norm, GQA, tied embeddings.
28L d_model=2048 16H (kv=8, head_dim 128) d_ff=6144 vocab=151936.
[hf:Qwen/Qwen3-1.7B family; hf]"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936, qk_norm=True, tie_embeddings=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, qk_norm=True, tie_embeddings=True,
    act_dtype="float32",
)
