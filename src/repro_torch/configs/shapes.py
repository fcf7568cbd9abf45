"""Assigned input-shape set, one for every architecture (the port of
``repro.configs.shapes``).

  train_4k     seq 4,096  × global_batch 256   → train_step
  prefill_32k  seq 32,768 × global_batch 32    → prefill (forward, no grads)
  decode_32k   seq 32,768 × global_batch 128   → serve_step (1 new token,
                                                  KV cache of seq_len)
  long_500k    seq 524,288 × global_batch 1    → serve_step; sub-quadratic
                                                  archs only (ssm / hybrid)
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from ..models.config import ModelConfig

Kind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Kind


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason if skipped): a full-attention arch skips ``long_500k``."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: O(S²) at 524k infeasible — skip per assignment"
    return True, ""
