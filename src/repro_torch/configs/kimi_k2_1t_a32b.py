"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 routed experts top-8.
61L d_model=7168 64H (GQA kv=8 per the assignment table — the public K2 uses
MLA; the assigned config is authoritative, divergence noted in DESIGN.md),
expert_ff=2048, vocab=163840.  [arXiv:2501.kimi2; unverified]"""
from ..models import MoECfg, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    moe=MoECfg(
        num_experts=384,
        top_k=8,
        expert_ff=2048,
        shared_experts=1,
        shared_ff=2048,
        first_dense_layers=1,
        dense_ff=18432,
    ),
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    act_dtype="float32",
    moe=MoECfg(
        num_experts=12,
        top_k=2,
        expert_ff=32,
        shared_experts=1,
        shared_ff=32,
        first_dense_layers=1,
        dense_ff=96,
    ),
)
