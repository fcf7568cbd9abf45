"""Decoder-only LM (the port of ``repro.models.transformer``): the ``dense``
family (GQA transformers: qwen3, minitron, qwen2, qwen1.5), the ``moe``
family (deepseek-v3 with MLA and multi-token prediction, kimi-k2 with GQA)
and the ``ssm`` family (RWKV-6).

Parameters and the decode cache keep the reference's trees: per-layer
leaves stacked on a leading layer axis (``layers``, and for ``moe`` the
leading dense ``dense_layers``), weights ``(in, out)``, activations
``(B, S, D)``.  A Python loop over the layers stands in for ``lax.scan``;
the stacked leaves are unbound once a call, so autograd stacks each leaf's
layer gradients once.  The ``hybrid``, ``vlm`` and ``audio`` families raise
``NotImplementedError`` naming the ROADMAP queue 1 item that ports each.

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
from .layers import (embed_decls, embed_lookup, glu, glu_decls, lm_logits, matmul, rmsnorm,
                     softmax_xent)
from .mla import mla_attention, mla_decls
from .moe import moe_block, moe_decls
from .params import ParamDecl, map_decls
from .rwkv import rwkv_block, rwkv_block_decls, rwkv_init_state

_PORTED_FAMILIES = ("dense", "moe", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED_FAMILIES:
        raise not_ported(f"the {cfg.family!r} family ({cfg.name})", FAMILY_ITEMS[cfg.family])


def stack_decls(decls: Any, n: int) -> Any:
    return map_decls(
        lambda d: ParamDecl((n,) + d.shape, ("layers",) + d.axes, d.init, d.scale), decls
    )


def _attn_block_decls(cfg: ModelConfig, ff: int, use_moe: bool = False) -> dict:
    if cfg.mla is not None:
        attn = mla_decls(cfg)
    else:
        attn = attn_decls(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd(),
                          qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
    return {
        "ln1": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        "ln2": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn,
        "mlp": moe_decls(cfg) if use_moe else glu_decls(cfg.d_model, ff, cfg.mlp_act),
    }


def _dense_layers(cfg: ModelConfig) -> int:
    """The leading dense layers of a ``moe`` config (deepseek-v3: 3)."""
    return cfg.moe.first_dense_layers if cfg.family == "moe" else 0


def lm_decls(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    decls: dict = {
        "embed": embed_decls(cfg.vocab_size, cfg.d_model),
        "final_ln": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
    }
    if cfg.mtp_depth > 0:
        # DeepSeek-V3 multi-token prediction (depth 1): at position t,
        # concat(norm(h_t), norm(embed(tok_{t+1}))) -> proj -> one dense
        # block -> the shared head, predicting tok_{t+2}
        decls["mtp"] = {
            "ln_h": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
            "ln_e": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
            "proj": ParamDecl((2 * cfg.d_model, cfg.d_model), (None, "embed")),
            "block": _attn_block_decls(cfg, (cfg.moe.dense_ff if cfg.moe else 0) or cfg.d_ff),
            "final_ln": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        }
    if not cfg.tie_embeddings:
        decls["head"] = ParamDecl(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), scale=0.02
        )
    if cfg.family == "ssm":
        decls["layers"] = stack_decls(rwkv_block_decls(cfg), cfg.num_layers)
    elif cfg.family == "moe":
        n_dense = _dense_layers(cfg)
        if n_dense:
            decls["dense_layers"] = stack_decls(
                _attn_block_decls(cfg, cfg.moe.dense_ff or cfg.d_ff), n_dense)
        decls["layers"] = stack_decls(_attn_block_decls(cfg, cfg.d_ff, use_moe=True),
                                      cfg.num_layers - n_dense)
    else:
        decls["layers"] = stack_decls(_attn_block_decls(cfg, cfg.d_ff), cfg.num_layers)
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


def _attend(h, lp, cfg: ModelConfig, q_pos, cache=None, cache_idx=None):
    if cfg.mla is not None:
        return mla_attention(h, lp["attn"], cfg, q_pos, cache=cache, cache_idx=cache_idx)
    return attention(h, lp["attn"], cfg, q_pos, cache=cache, cache_idx=cache_idx)


def _attn_mlp_block(x, lp, cfg: ModelConfig, q_pos, use_moe: bool = False):
    """The block's output and its MoE aux loss (a float32 0 for a dense MLP)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    a, _ = _attend(h, lp, cfg, q_pos)
    x = x + a
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if use_moe:
        m, aux = moe_block(h, lp["mlp"], cfg)
    else:
        m = glu(h, lp["mlp"], act=cfg.mlp_act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m, aux


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
    """Logits ``(B, S, vocab)`` in ``cfg.adt()``, the MoE aux loss summed
    over the routed layers (float32; 0 for the other families) and the
    last hidden state."""
    _check_family(cfg)
    x = embed_lookup(tokens, params["embed"]).to(cfg.adt())
    B, S, _ = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        body = _remat(lambda c, lp: rwkv_block(c, lp, cfg)[0], cfg)
        for lp in unbind_layers(params["layers"], cfg.num_layers):
            x = body(x, lp)
        return _head(params, x, cfg), aux, x
    q_pos = torch.arange(S, device=x.device).expand(B, S)
    n_dense = _dense_layers(cfg)
    if n_dense:
        body_d = _remat(lambda c, lp: _attn_mlp_block(c, lp, cfg, q_pos)[0], cfg)
        for lp in unbind_layers(params["dense_layers"], n_dense):
            x = body_d(x, lp)
    use_moe = cfg.family == "moe"
    body = _remat(lambda c, lp: _attn_mlp_block(c, lp, cfg, q_pos, use_moe), cfg)
    auxs = []
    for lp in unbind_layers(params["layers"], cfg.num_layers - n_dense):
        x, a = body(x, lp)
        auxs.append(a)
    if use_moe:
        aux = torch.sum(torch.stack(auxs))
    return _head(params, x, cfg), aux, x


def lm_loss(
    params: dict, batch: dict, cfg: ModelConfig,
    aux_coef: float = 1e-2, mtp_coef: float = 0.3,
) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (position t predicts ``labels[t + 1]``) plus
    ``aux_coef`` times the MoE aux loss; metrics ``xent`` and ``moe_aux``.
    With ``mtp_depth > 0`` and ``"mtp"`` in the parameters, plus
    ``mtp_coef`` times the multi-token-prediction loss (metric ``mtp``)."""
    logits, aux, hidden = lm_forward(params, batch["tokens"], cfg)
    loss = softmax_xent(logits[:, :-1, :], batch["labels"][:, 1:])
    total = loss + aux_coef * aux
    metrics = {"xent": loss, "moe_aux": aux}
    if cfg.mtp_depth > 0 and "mtp" in params:
        mtp_loss = _mtp_loss(params, batch, cfg, hidden)
        total = total + mtp_coef * mtp_loss
        metrics["mtp"] = mtp_loss
    return total, metrics


def _mtp_loss(params: dict, batch: dict, cfg: ModelConfig, hidden: torch.Tensor):
    """Depth-1 MTP: predict tok_{t+2} from (h_t, embed(tok_{t+1}))."""
    mp = params["mtp"]
    toks = batch["tokens"]
    B, S = toks.shape
    h = rmsnorm(hidden[:, : S - 1, :], mp["ln_h"], cfg.norm_eps)
    e = rmsnorm(embed_lookup(toks[:, 1:], params["embed"]).to(h.dtype), mp["ln_e"],
                cfg.norm_eps)
    x = matmul(torch.cat([h, e], dim=-1), mp["proj"])
    q_pos = torch.arange(S - 1, device=x.device).expand(B, S - 1)
    x, _ = _attn_mlp_block(x, mp["block"], cfg, q_pos)
    x = rmsnorm(x, mp["final_ln"], cfg.norm_eps)
    head = params.get("head")
    logits = lm_logits(x, head if head is not None else params["embed"].T)
    # position t (0..S-3) predicts labels[t+2]
    return softmax_xent(logits[:, : S - 2, :], batch["labels"][:, 2:])


# -- decode ---------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda", dtype: torch.dtype | None = None) -> dict:
    """The decode cache, stacked over layers: for attention, k/v of
    ``(layers, B, max_seq, KVH, hd)`` in ``cfg.adt()``, or with MLA the
    latent ``ckv`` ``(layers, B, max_seq, kv_lora)`` and ``krope``
    ``(layers, B, max_seq, rope_dim)``, under ``layers`` and, for a ``moe``
    config with leading dense layers, ``dense_layers``; for ``ssm``, the
    token-shift carries in ``cfg.adt()`` and the float32 WKV state, whose
    size does not grow with ``max_seq``."""
    _check_family(cfg)
    dev = as_device(device)
    if cfg.family == "ssm":
        st = rwkv_init_state(cfg, batch, dev)
        return {key: a[None].repeat((cfg.num_layers,) + (1,) * a.ndim) for key, a in st.items()}
    dtype = dtype or cfg.adt()

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(n_layers):
        if cfg.mla is not None:
            m = cfg.mla
            return {"ckv": zeros(n_layers, batch, max_seq, m.kv_lora),
                    "krope": zeros(n_layers, batch, max_seq, m.rope_dim)}
        return {key: zeros(n_layers, batch, max_seq, cfg.num_kv_heads, cfg.hd())
                for key in ("k", "v")}

    n_dense = _dense_layers(cfg)
    cache = {"layers": kv(cfg.num_layers - n_dense)}
    if n_dense:
        cache["dense_layers"] = kv(n_dense)
    return cache


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
    if cfg.family == "ssm":
        states = []
        for i, lp in enumerate(unbind_layers(params["layers"], cfg.num_layers)):
            x, st = rwkv_block(x, lp, cfg, state=layer(cache, i))
            states.append(st)
        return _head(params, x, cfg), _stack(states)
    # S tokens at consecutive positions from idx
    q_pos = (idx + torch.arange(S, device=x.device)).expand(B, S)

    def stack_step(x, key, n_layers, use_moe):
        states = []
        for i, lp in enumerate(unbind_layers(params[key], n_layers)):
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            a, nc = _attend(h, lp, cfg, q_pos, cache=layer(cache[key], i), cache_idx=idx)
            x = x + a
            h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
            m = moe_block(h, lp["mlp"], cfg)[0] if use_moe else glu(h, lp["mlp"],
                                                                     act=cfg.mlp_act)
            x = x + m
            states.append(nc)
        return x, _stack(states)

    new_cache = {}
    n_dense = _dense_layers(cfg)
    if n_dense:
        x, new_cache["dense_layers"] = stack_step(x, "dense_layers", n_dense, False)
    x, new_cache["layers"] = stack_step(x, "layers", cfg.num_layers - n_dense,
                                        cfg.family == "moe")
    return _head(params, x, cfg), new_cache
