"""Unified model configuration covering the whole assigned architecture zoo
(the port's copy of ``repro.models.config``; ``adt`` returns a torch dtype).

One frozen dataclass parameterizes every family:
  dense GQA transformers (qwen3 / minitron / qwen2 / qwen1.5 / pixtral backbone)
  MoE transformers        (deepseek-v3 with MLA, kimi-k2 with GQA)
  attention-free SSM      (rwkv6)
  hybrid                  (recurrentgemma: RG-LRU + local attention, 2:1)
  encoder-decoder audio   (whisper-medium, conv frontend stubbed)

Frozen and hashable, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]

@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    expert_ff: int
    shared_experts: int = 0
    shared_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # leading dense layers (deepseek: 3)
    dense_ff: int = 0  # ff of those dense layers
    router_scale: float = 1.0
    groups: int = 1  # routing groups (= data shards) for shard-local sort


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    head_size: int = 64
    w_lora: int = 64
    gate_lora: int = 128
    ffn_mult: float = 3.5  # d_ff = ffn_mult * d (rwkv6 uses 3.5x with relu²)


@dataclasses.dataclass(frozen=True)
class GriffinCfg:
    lru_width: int = 2560
    conv_width: int = 4
    window: int = 2048
    pattern: tuple[str, ...] = ("rec", "rec", "attn")  # repeating block pattern
    c_scale: float = 8.0  # RG-LRU decay sharpness


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    encoder_layers: int = 24
    num_frames: int = 1500  # stubbed conv frontend output length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mlp_act: str = "silu"  # "silu" | "gelu" (GLU) | "relu2" (non-gated, nemotron)
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    rwkv: RWKVCfg | None = None
    griffin: GriffinCfg | None = None
    encdec: EncDecCfg | None = None
    vlm_patches: int = 0  # >0: accepts precomputed patch embeddings (stub)
    mtp_depth: int = 0  # deepseek multi-token-prediction heads (optional)
    remat: str = "none"  # "none" | "full" | "dots" — set by shape configs
    scan_layers: bool = True
    act_dtype: str = "bfloat16"  # "float32" for CPU-executed smoke tests

    def adt(self) -> torch.dtype:
        return torch.bfloat16 if self.act_dtype == "bfloat16" else torch.float32

    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
