"""Uniform per-family model API (the port of ``repro.models.registry``).

Training and serving talk to a :class:`ModelAPI` and never dispatch on
family again.  The ``dense`` and ``ssm`` families have one; the others
raise ``NotImplementedError`` naming the ROADMAP queue 1 item that ports
each.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.types import as_device
from . import transformer as tf
from .config import FAMILY_ITEMS, ModelConfig, not_ported


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    decls: Callable[[ModelConfig], dict]
    loss: Callable[..., tuple[torch.Tensor, dict]]  # (params, batch, cfg)
    prefill: Callable[..., torch.Tensor]  # (params, batch, cfg) -> logits
    init_cache: Callable[..., dict]  # (cfg, batch, max_seq, device=...)
    decode_step: Callable[..., tuple[torch.Tensor, dict]]  # (params, cache, tok, idx, cfg)
    has_decode: bool = True


def _lm_prefill(params, batch, cfg: ModelConfig):
    logits, _, _ = tf.lm_forward(params, batch["tokens"], cfg)
    return logits


_LM_API = ModelAPI(
    decls=tf.lm_decls,
    loss=tf.lm_loss,
    prefill=_lm_prefill,
    init_cache=tf.init_cache,
    decode_step=tf.decode_step,
)


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "audio":
        raise not_ported(f"the audio family ({cfg.name})", FAMILY_ITEMS["audio"])
    return _LM_API


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               generator: torch.Generator | None = None,
               device: str | torch.device = "cuda") -> dict:
    """Synthetic token batch for this family (smoke runs and tests)."""
    dev = as_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    if cfg.family in ("audio", "vlm") or cfg.vlm_patches:
        family = "vlm" if cfg.vlm_patches else cfg.family
        raise not_ported(f"{cfg.name}'s inputs", FAMILY_ITEMS[family])
    return {
        "tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev),
        "labels": torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev),
    }
