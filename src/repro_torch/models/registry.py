"""Uniform per-family model API (the port of ``repro.models.registry``).

Training and serving talk to a :class:`ModelAPI` and never dispatch on
family again: the decoder-only families share one, the ``audio`` family
(whisper) has its own.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.types import as_device
from . import transformer as tf
from . import whisper as wh
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    decls: Callable[[ModelConfig], dict]
    loss: Callable[..., tuple[torch.Tensor, dict]]  # (params, batch, cfg)
    prefill: Callable[..., torch.Tensor]  # (params, batch, cfg) -> logits
    init_cache: Callable[..., dict]  # (cfg, batch, max_seq, device=...)
    decode_step: Callable[..., tuple[torch.Tensor, dict]]  # (params, cache, tok, idx, cfg)
    has_decode: bool = True


def _lm_prefill(params, batch, cfg: ModelConfig):
    logits, _, _ = tf.lm_forward(params, batch["tokens"], cfg,
                                 image_embeds=batch.get("image_embeds"))
    return logits


def _whisper_prefill(params, batch, cfg: ModelConfig):
    enc = wh.encode(params, batch["frames"], cfg)
    return wh.decode_train(params, batch["tokens"], enc, cfg)


_LM_API = ModelAPI(
    decls=tf.lm_decls,
    loss=tf.lm_loss,
    prefill=_lm_prefill,
    init_cache=tf.init_cache,
    decode_step=tf.decode_step,
)


_WHISPER_API = ModelAPI(
    decls=wh.whisper_decls,
    loss=wh.whisper_loss,
    prefill=_whisper_prefill,
    init_cache=wh.whisper_init_cache,
    decode_step=wh.whisper_decode_step,
)


def get_api(cfg: ModelConfig) -> ModelAPI:
    return _WHISPER_API if cfg.family == "audio" else _LM_API


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               generator: torch.Generator | None = None,
               device: str | torch.device = "cuda") -> dict:
    """Synthetic batch with the reference's structure for this family (smoke
    runs and tests): tokens and labels; for ``audio`` also ``frames``
    (B, num_frames, D), for a config with ``vlm_patches`` P also
    ``image_embeds`` (B, P, D) and the text cut to ``max(seq - P, 8)``.
    Floats are in ``cfg.adt()``; every draw comes from ``generator``, in the
    order the reference splits its keys."""
    dev = as_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (batch, n), generator=gen, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(cfg.adt())

    if cfg.family == "audio":
        frames = normal(batch, cfg.encdec.num_frames, cfg.d_model)
        return {"frames": frames, "tokens": tokens(seq), "labels": tokens(seq)}
    text = max(seq - cfg.vlm_patches, 8) if cfg.vlm_patches else seq
    b = {"tokens": tokens(text), "labels": tokens(text)}
    if cfg.vlm_patches:
        b["image_embeds"] = normal(batch, cfg.vlm_patches, cfg.d_model)
    return b
