"""Decoder-only LM (the port of ``repro.models.transformer``): the ``dense``
family (GQA transformers: qwen3, minitron, qwen2, qwen1.5) and the ``ssm``
family (RWKV-6).

Parameters and the decode cache keep the reference's trees: per-layer
leaves stacked on a leading ``num_layers`` axis, weights ``(in, out)``,
activations ``(B, S, D)``.  A Python loop over the layers stands in for
``lax.scan``; the stacked leaves are unbound once a call, so autograd
stacks each leaf's layer gradients once.  The ``moe``, ``hybrid``, ``vlm``
and ``audio`` families raise ``NotImplementedError`` naming the ROADMAP
queue 1 item that ports each.

  lm_decls(cfg)                             → ParamDecl tree
  lm_forward(params, tokens, cfg)           → (logits, aux, hidden)
  lm_loss(params, batch, cfg)               → (scalar, metrics)
  init_cache(cfg, batch, max_seq)           → decode cache
  decode_step(params, cache, tok, idx, cfg) → (logits, new cache)
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.utils.checkpoint as ckpt

from ..core.types import as_device
from .attention import attention, attn_decls
from .config import FAMILY_ITEMS, ModelConfig, not_ported
from .layers import embed_decls, embed_lookup, glu, glu_decls, lm_logits, rmsnorm, softmax_xent
from .params import ParamDecl, map_decls
from .rwkv import rwkv_block, rwkv_block_decls, rwkv_init_state

_PORTED_FAMILIES = ("dense", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED_FAMILIES:
        raise not_ported(f"the {cfg.family!r} family ({cfg.name})", FAMILY_ITEMS[cfg.family])
    if cfg.mla is not None or cfg.moe is not None or cfg.mtp_depth > 0:
        raise not_ported(f"{cfg.name}'s MoE, MLA or multi-token prediction",
                         FAMILY_ITEMS["moe"])


def stack_decls(decls: Any, n: int) -> Any:
    return map_decls(
        lambda d: ParamDecl((n,) + d.shape, ("layers",) + d.axes, d.init, d.scale), decls
    )


def _attn_block_decls(cfg: ModelConfig, ff: int) -> dict:
    return {
        "ln1": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        "ln2": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_decls(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd(),
                           qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm),
        "mlp": glu_decls(cfg.d_model, ff, cfg.mlp_act),
    }


def lm_decls(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    decls: dict = {
        "embed": embed_decls(cfg.vocab_size, cfg.d_model),
        "final_ln": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        decls["head"] = ParamDecl(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), scale=0.02
        )
    block = rwkv_block_decls(cfg) if cfg.family == "ssm" else _attn_block_decls(cfg, cfg.d_ff)
    decls["layers"] = stack_decls(block, cfg.num_layers)
    return decls


def layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a tree whose leaves are stacked over layers."""
    if isinstance(tree, dict):
        return {key: layer(val, i) for key, val in tree.items()}
    return tree[i]


def unbind_layers(tree: Any, n: int) -> list:
    """The ``n`` layers of a layer-stacked tree, each leaf unbound once."""
    if isinstance(tree, dict):
        per_key = {key: unbind_layers(val, n) for key, val in tree.items()}
        return [{key: vals[i] for key, vals in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees: list[dict]) -> dict:
    return {key: (_stack([t[key] for t in trees]) if isinstance(trees[0][key], dict)
                  else torch.stack([t[key] for t in trees]))
            for key in trees[0]}


def _head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    head = params.get("head")
    return lm_logits(x, head if head is not None else params["embed"].T)


# -- block bodies --------------------------------------------------------------


def _attn_mlp_block(x, lp, cfg: ModelConfig, q_pos):
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    a, _ = attention(h, lp["attn"], cfg, q_pos)
    x = x + a
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + glu(h, lp["mlp"], act=cfg.mlp_act)


# matrix products without batch dimensions: the weight products, which
# "dots" keeps (jax's dots_with_no_batch_dims_saveable); attention's batched
# products are recomputed
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    if op in _SAVED_PRODUCTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the config's rematerialisation: ``"full"`` recomputes the
    whole block in the backward pass, ``"dots"`` keeps the weight products'
    outputs and recomputes the rest."""
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_products)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, context_fn=context)
    if cfg.remat != "none":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return fn


# -- forward / loss -------------------------------------------------------------


def lm_forward(
    params: dict, tokens: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Logits ``(B, S, vocab)`` in ``cfg.adt()``, the MoE aux loss (0 for
    these families) and the last hidden state."""
    _check_family(cfg)
    x = embed_lookup(tokens, params["embed"]).to(cfg.adt())
    B, S, _ = x.shape
    layers = unbind_layers(params["layers"], cfg.num_layers)
    if cfg.family == "ssm":
        body = _remat(lambda c, lp: rwkv_block(c, lp, cfg)[0], cfg)
    else:
        q_pos = torch.arange(S, device=x.device).expand(B, S)
        body = _remat(lambda c, lp: _attn_mlp_block(c, lp, cfg, q_pos), cfg)
    for lp in layers:
        x = body(x, lp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg), aux, x


def lm_loss(
    params: dict, batch: dict, cfg: ModelConfig,
    aux_coef: float = 1e-2, mtp_coef: float = 0.3,
) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (position t predicts ``labels[t + 1]``) plus
    ``aux_coef`` times the MoE aux loss; metrics ``xent`` and ``moe_aux``.
    ``mtp_coef`` weighs the multi-token-prediction loss, which comes with
    the MoE item."""
    logits, aux, _ = lm_forward(params, batch["tokens"], cfg)
    loss = softmax_xent(logits[:, :-1, :], batch["labels"][:, 1:])
    return loss + aux_coef * aux, {"xent": loss, "moe_aux": aux}


# -- decode ---------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda", dtype: torch.dtype | None = None) -> dict:
    """The decode cache, stacked over layers: for ``dense``, k/v of
    ``(num_layers, B, max_seq, KVH, hd)`` in ``cfg.adt()``; for ``ssm``, the
    token-shift carries in ``cfg.adt()`` and the float32 WKV state, whose
    size does not grow with ``max_seq``."""
    _check_family(cfg)
    dev = as_device(device)
    if cfg.family == "ssm":
        st = rwkv_init_state(cfg, batch, dev)
        return {key: a[None].repeat((cfg.num_layers,) + (1,) * a.ndim) for key, a in st.items()}
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.hd())
    dtype = dtype or cfg.adt()
    return {"layers": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}}


def decode_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # (B, S): S = 1 per-token decode, S > 1 chunked prefill
    idx: int,  # position of tokens[:, 0]
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """Logits ``(B, S, vocab)`` for the S tokens and the advanced cache."""
    _check_family(cfg)
    x = embed_lookup(tokens, params["embed"]).to(cfg.adt())
    B, S = tokens.shape
    layers = unbind_layers(params["layers"], cfg.num_layers)
    states = []
    if cfg.family == "ssm":
        for i, lp in enumerate(layers):
            x, st = rwkv_block(x, lp, cfg, state=layer(cache, i))
            states.append(st)
        return _head(params, x, cfg), _stack(states)
    # S tokens at consecutive positions from idx
    q_pos = (idx + torch.arange(S, device=x.device)).expand(B, S)
    for i, lp in enumerate(layers):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, nc = attention(h, lp["attn"], cfg, q_pos, cache=layer(cache["layers"], i),
                          cache_idx=idx)
        x = x + a
        h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + glu(h, lp["mlp"], act=cfg.mlp_act)
        states.append(nc)
    return _head(params, x, cfg), {"layers": _stack(states)}
