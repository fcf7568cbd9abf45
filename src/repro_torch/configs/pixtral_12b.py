"""pixtral-12b [vlm]: Pixtral ViT frontend (stubbed) + Mistral-NeMo-style
backbone.  40L d=5120 32H (GQA kv=8, head_dim 128) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, rope_theta=1e6, vlm_patches=256,
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, rope_theta=1e6, vlm_patches=8, act_dtype="float32",
)
