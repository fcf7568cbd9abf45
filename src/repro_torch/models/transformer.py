"""Decoder-only LM (the port of ``repro.models.transformer``), the
``ssm`` family (RWKV-6) only.

Parameters and the decode cache keep the reference's trees: per-layer
leaves stacked on a leading ``num_layers`` axis, weights ``(in, out)``,
activations ``(B, S, D)``.  A Python loop over the layers stands in for
``lax.scan``.  The other families raise ``NotImplementedError`` until
ROADMAP queue 1, 'Model zoo and training' ports them.

  lm_decls(cfg)                             → ParamDecl tree
  lm_forward(params, tokens, cfg)           → (logits, aux, hidden)
  init_cache(cfg, batch, max_seq)           → decode cache
  decode_step(params, cache, tok, idx, cfg) → (logits, new cache)
"""
from __future__ import annotations

from typing import Any

import torch

from ..core.types import as_device
from .config import ModelConfig
from .layers import embed_lookup, lm_logits, rmsnorm
from .params import ParamDecl, map_decls
from .rwkv import rwkv_block, rwkv_block_decls, rwkv_init_state


def _not_ported(cfg: ModelConfig) -> NotImplementedError:
    return NotImplementedError(
        f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
        "ROADMAP queue 1, 'Model zoo and training'"
    )


def stack_decls(decls: Any, n: int) -> Any:
    return map_decls(
        lambda d: ParamDecl((n,) + d.shape, ("layers",) + d.axes, d.init, d.scale), decls
    )


def lm_decls(cfg: ModelConfig) -> dict:
    if cfg.family != "ssm":
        raise _not_ported(cfg)
    decls: dict = {
        "embed": ParamDecl((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="embed",
                           scale=0.02),
        "final_ln": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        "layers": stack_decls(rwkv_block_decls(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        decls["head"] = ParamDecl(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), scale=0.02
        )
    return decls


def layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a tree whose leaves are stacked over layers."""
    if isinstance(tree, dict):
        return {key: layer(val, i) for key, val in tree.items()}
    return tree[i]


def _stack(trees: list[dict]) -> dict:
    return {key: (_stack([t[key] for t in trees]) if isinstance(trees[0][key], dict)
                  else torch.stack([t[key] for t in trees]))
            for key in trees[0]}


def _head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    head = params.get("head")
    return lm_logits(x, head if head is not None else params["embed"].T)


def lm_forward(
    params: dict, tokens: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Logits ``(B, S, vocab)`` in ``cfg.adt()``, the MoE aux loss (0 here)
    and the last hidden state."""
    if cfg.family != "ssm":
        raise _not_ported(cfg)
    x = embed_lookup(tokens, params["embed"]).to(cfg.adt())
    for i in range(cfg.num_layers):
        x, _ = rwkv_block(x, layer(params["layers"], i), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg), aux, x


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda") -> dict:
    """The ``ssm`` decode cache: token-shift carries in ``cfg.adt()`` and the
    float32 WKV state, stacked over layers.  Its size does not grow with
    ``max_seq``."""
    if cfg.family != "ssm":
        raise _not_ported(cfg)
    st = rwkv_init_state(cfg, batch, as_device(device))
    return {key: a[None].repeat((cfg.num_layers,) + (1,) * a.ndim) for key, a in st.items()}


def decode_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # (B, S): S = 1 per-token decode, S > 1 chunked prefill
    idx: int,  # position of tokens[:, 0]; the ssm state does not need it
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """Logits ``(B, S, vocab)`` for the S tokens and the advanced cache."""
    if cfg.family != "ssm":
        raise _not_ported(cfg)
    x = embed_lookup(tokens, params["embed"]).to(cfg.adt())
    states = []
    for i in range(cfg.num_layers):
        x, st = rwkv_block(x, layer(params["layers"], i), cfg, state=layer(cache, i))
        states.append(st)
    return _head(params, x, cfg), _stack(states)
