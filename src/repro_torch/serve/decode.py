"""Serving steps and a batched generation loop (the port of
``repro.serve.decode``).

``make_serve_steps(cfg)`` returns (prefill_fn, decode_fn):

  prefill_fn(params, batch)              -> logits (B, S, V)
  decode_fn(params, cache, tokens, idx)  -> (logits (B, S, V), new cache)

``generate`` seeds the cache with one chunked prefill of the whole prompt
at ``idx = 0`` and then decodes token by token, as the reference does for
every family but the token-by-token ones (``hybrid``, ``audio``), whose
cache it warms one prompt token a step.  A Python loop stands in for
``lax.fori_loop``.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from ..models import ModelConfig, get_api
from ..models.params import tree_leaves


def make_serve_steps(cfg: ModelConfig) -> tuple[Callable, Callable]:
    api = get_api(cfg)

    def prefill(params, batch):
        return api.prefill(params, batch, cfg)

    def decode(params, cache, tokens, idx):
        return api.decode_step(params, cache, tokens, idx, cfg)

    return prefill, decode


def sample_token(logits: torch.Tensor, generator: torch.Generator | None = None,
                 temperature: float = 0.0) -> torch.Tensor:
    """logits (B, S, V) → the next tokens (B, 1) int32, from the last position.

    Greedy is the first index of the maximum (``torch.argmax`` and
    ``jnp.argmax`` both take the first on ties).  With a temperature, Gumbel noise from ``generator`` is added to the
    scaled logits; it cannot repeat ``jax.random``'s bits.  Sharded
    (DTensor) logits give plain tokens, the same on every rank.
    """
    last = logits[:, -1, :].float()
    if isinstance(last, DTensor):  # the last position's logits, whole on every rank
        last = last.full_tensor()
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    u = torch.rand(last.shape, generator=generator, device=last.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(last / temperature + gumbel, dim=-1)[:, None].to(torch.int32)


def no_grad(params) -> contextlib.AbstractContextManager:
    """``torch.inference_mode()``, or ``torch.no_grad()`` for DTensor
    parameters (DTensor ops do not run on inference tensors)."""
    if any(isinstance(leaf, DTensor) for leaf in tree_leaves(params)):
        return torch.no_grad()
    return torch.inference_mode()


# families whose decode state advances strictly one token at a time; the
# reference warms their cache token by token instead of the chunked prefill
_TOKEN_BY_TOKEN_FAMILIES = ("hybrid", "audio")


def generate(
    params: dict,
    cfg: ModelConfig,
    prompt: torch.Tensor,  # (B, S0) int
    max_new: int,
    temperature: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Prompt and continuation, (B, S0 + max_new) int32, on the prompt's device.

    The whole prompt goes through ``decode_step`` as one (B, S0) chunk at
    ``idx = 0`` (for RWKV-6 one ``wkv6`` launch a layer; for the dense
    family the prompt's K/V written into the cache at once), and its last
    position's logits give the first new token; then ``max_new - 1`` steps
    of one token each.  The token-by-token families instead feed prompt
    token i at step i, and sample the first new token from step S0 - 1.  An
    ``audio`` config decodes against the zero cross cache of its
    ``init_cache``, as the reference's ``generate`` does.
    """
    if max_new < 1:
        raise ValueError(f"max_new must be at least 1, got {max_new}")
    api = get_api(cfg)
    B, S0 = prompt.shape
    dev = prompt.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    cache = api.init_cache(cfg, B, S0 + max_new, device=dev)
    with no_grad(params):
        if cfg.family in _TOKEN_BY_TOKEN_FAMILIES:
            for i in range(S0):
                logits, cache = api.decode_step(params, cache, prompt[:, i:i + 1], i, cfg)
        else:
            logits, cache = api.decode_step(params, cache, prompt, 0, cfg)
        cur = sample_token(logits, gen, temperature)
        toks = [prompt.to(torch.int32), cur]
        for i in range(S0, S0 + max_new - 1):
            logits, cache = api.decode_step(params, cache, cur, i, cfg)
            cur = sample_token(logits, gen, temperature)
            toks.append(cur)
    return torch.cat(toks, dim=1)
