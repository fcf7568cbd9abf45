"""whisper-medium [audio]: encoder-decoder, conv/mel frontend stubbed
(input_specs supplies 1500 precomputed frame embeddings).
24 enc + 24 dec layers, d_model=1024 16H (kv=16, head_dim 64) d_ff=4096
vocab=51865.  [arXiv:2212.04356; unverified]"""
from ..models import EncDecCfg, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865, tie_embeddings=True,
    encdec=EncDecCfg(encoder_layers=24, num_frames=1500),
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, tie_embeddings=True, act_dtype="float32",
    encdec=EncDecCfg(encoder_layers=2, num_frames=12),
)
