"""deepseek-v3-671b [moe]: MLA + 1 shared + 256 routed top-8 experts.
61L d_model=7168 128H, expert_ff=2048, first 3 layers dense (ff 18432),
vocab=129280.  MTP available via mtp_depth (off in dry-run cells).
[arXiv:2412.19437; hf]"""
from ..models import MLACfg, MoECfg, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    mla=MLACfg(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128, v_dim=128),
    moe=MoECfg(
        num_experts=256,
        top_k=8,
        expert_ff=2048,
        shared_experts=1,
        shared_ff=2048,
        first_dense_layers=3,
        dense_ff=18432,
    ),
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    act_dtype="float32",
    mla=MLACfg(q_lora=32, kv_lora=16, rope_dim=8, nope_dim=16, v_dim=16),
    moe=MoECfg(
        num_experts=8,
        top_k=2,
        expert_ff=32,
        shared_experts=1,
        shared_ff=32,
        first_dense_layers=1,
        dense_ff=96,
    ),
)
