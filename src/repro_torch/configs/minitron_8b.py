"""minitron-8b [dense]: width/depth-pruned Nemotron-4.
32L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff=16384 vocab=256000.
[arXiv:2407.14679; hf]"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000, mlp_act="relu2",
)

SMOKE = ModelConfig(
    name="minitron-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, act_dtype="float32", mlp_act="relu2",
)
