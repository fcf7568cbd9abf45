"""Decoder-only LM (the port of ``repro.models.transformer``): the ``dense``
family (GQA transformers: qwen3, minitron, qwen2, qwen1.5), the ``vlm``
family (pixtral: the dense backbone with patch embeddings in front of the
text), the ``moe`` family (deepseek-v3 with MLA and multi-token prediction,
kimi-k2 with GQA), the ``ssm`` family (RWKV-6) and the ``hybrid`` family
(recurrentgemma: RG-LRU and local attention, ``models/griffin.py``).  The
``audio`` family has its own API (``models/whisper.py``).

Parameters and the decode cache keep the reference's trees: per-layer
leaves stacked on a leading layer axis (``layers``, and for ``moe`` the
leading dense ``dense_layers``; for ``hybrid`` the repeating ``units`` and
the ``tail`` list of the layers left over), weights ``(in, out)``,
activations ``(B, S, D)``.  A Python loop over the layers stands in for
``lax.scan``; the stacked leaves are unbound once a call, so autograd
stacks each leaf's layer gradients once.  Under a mesh (parameters that
are DTensors, ``sharding.use_mesh``) the reference's ``shard`` layout hints
stand at its sites; the batch reaches the model replicated and the hint
after the embedding puts it on ``data`` by local slicing, as GSPMD does.

  lm_decls(cfg)                             → ParamDecl tree
  lm_forward(params, tokens, cfg, image_embeds=None) → (logits, aux, hidden)
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
from ..sharding import replicate, shard
from .attention import attention, attn_decls
from .config import ModelConfig
from .griffin import griffin_layer, griffin_layer_decls
from .layers import (embed_decls, embed_lookup, glu, glu_decls, lm_logits, matmul, rmsnorm,
                     softmax_xent)
from .mla import mla_attention, mla_decls
from .moe import moe_block, moe_decls
from .params import ParamDecl, map_decls
from .rwkv import rwkv_block, rwkv_block_decls, rwkv_init_state

_PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED_FAMILIES:
        raise ValueError(f"the {cfg.family!r} family ({cfg.name}) has its own model API: "
                         "models.get_api(cfg)")


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
    elif cfg.family == "hybrid":
        pat = cfg.griffin.pattern
        n_units, n_tail = _hybrid_units(cfg)
        unit = {f"b{i}_{k}": griffin_layer_decls(cfg, k) for i, k in enumerate(pat)}
        decls["units"] = stack_decls(unit, n_units)
        decls["tail"] = [griffin_layer_decls(cfg, pat[i]) for i in range(n_tail)]
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


def _hybrid_units(cfg: ModelConfig) -> tuple[int, int]:
    """A ``hybrid`` config's repeats of its pattern and the layers left over."""
    n_units = cfg.num_layers // len(cfg.griffin.pattern)
    return n_units, cfg.num_layers - n_units * len(cfg.griffin.pattern)


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
    # the residual stream whole across the model axis (here and in every
    # family's blocks): a partial sum left in it would reach the MLP, whose
    # product DTensor then runs on every rank with the weight gathered whole
    x = shard(x + a, "batch", "seq", "act_embed")
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if use_moe:
        m, aux = moe_block(h, lp["mlp"], cfg)
    else:
        m = glu(h, lp["mlp"], act=cfg.mlp_act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard(x + m, "batch", "seq", "act_embed"), aux


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
    params: dict, tokens: torch.Tensor, cfg: ModelConfig,
    image_embeds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Logits ``(B, S, vocab)`` in ``cfg.adt()``, the MoE aux loss summed
    over the routed layers (float32; 0 for the other families) and the
    last hidden state.  A ``vlm`` config's ``image_embeds`` (B, P, D) go in
    front of the token embeddings (S = P + the text's length)."""
    _check_family(cfg)
    x = embed_lookup(tokens, params["embed"]).to(cfg.adt())
    if cfg.vlm_patches and image_embeds is not None:
        x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    x = shard(x, "batch", "seq", "act_embed")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def logits(x):
        return shard(_head(params, x, cfg), "batch", "seq", "vocab")

    if cfg.family == "ssm":
        body = _remat(lambda c, lp: rwkv_block(c, lp, cfg)[0], cfg)
        for lp in unbind_layers(params["layers"], cfg.num_layers):
            x = body(x, lp)
        return logits(x), aux, x
    q_pos = torch.arange(S, device=x.device).expand(B, S)
    if cfg.family == "hybrid":
        pat = cfg.griffin.pattern
        n_units, _ = _hybrid_units(cfg)

        def unit_body(c, lp):
            for i, k in enumerate(pat):
                c, _ = griffin_layer(c, lp[f"b{i}_{k}"], cfg, k, q_pos)
            return c

        body = _remat(unit_body, cfg)
        for lp in unbind_layers(params["units"], n_units):
            x = body(x, lp)
        for i, lp in enumerate(params.get("tail", [])):
            x, _ = griffin_layer(x, lp, cfg, pat[i], q_pos)
        return logits(x), aux, x
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
    return logits(x), aux, x


def lm_loss(
    params: dict, batch: dict, cfg: ModelConfig,
    aux_coef: float = 1e-2, mtp_coef: float = 0.3,
) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (position t predicts ``labels[t + 1]``) plus
    ``aux_coef`` times the MoE aux loss; metrics ``xent`` and ``moe_aux``.
    With ``mtp_depth > 0`` and ``"mtp"`` in the parameters, plus
    ``mtp_coef`` times the multi-token-prediction loss (metric ``mtp``).
    With ``image_embeds`` in the batch, the patches' P positions predict
    nothing."""
    image_embeds = batch.get("image_embeds")
    logits, aux, hidden = lm_forward(params, batch["tokens"], cfg, image_embeds=image_embeds)
    P = cfg.vlm_patches if image_embeds is not None else 0
    loss = softmax_xent(logits[:, P:][:, :-1, :], batch["labels"][:, 1:])
    # each term whole before they meet: under a mesh the token mean and the
    # MoE aux are partial sums of different kinds (an average, a sum)
    total = replicate(loss) + aux_coef * replicate(aux)
    metrics = {"xent": loss, "moe_aux": aux}
    if cfg.mtp_depth > 0 and "mtp" in params:
        mtp_loss = _mtp_loss(params, batch, cfg, hidden[:, P:, :])
        total = total + mtp_coef * replicate(mtp_loss)
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
    size does not grow with ``max_seq``; for ``hybrid``, under ``units``
    (stacked over the units) and ``tail`` (a list), each recurrent layer's
    conv tail ``(B, conv_width - 1, lru_width)`` and float32 RG-LRU state
    ``(B, lru_width)``, each attention layer's rolling window k/v of
    ``(B, min(window, max_seq), KVH, hd)``."""
    _check_family(cfg)
    dev = as_device(device)
    if cfg.family == "ssm":
        st = rwkv_init_state(cfg, batch, dev)
        return {key: a[None].repeat((cfg.num_layers,) + (1,) * a.ndim) for key, a in st.items()}
    dtype = dtype or cfg.adt()

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family == "hybrid":
        g = cfg.griffin
        n_units, n_tail = _hybrid_units(cfg)
        W = min(g.window, max_seq)

        def state(kind, *lead):
            if kind == "rec":
                return {"conv": zeros(*lead, batch, g.conv_width - 1, g.lru_width),
                        "lru": zeros(*lead, batch, g.lru_width, dt=torch.float32)}
            return {key: zeros(*lead, batch, W, cfg.num_kv_heads, cfg.hd()) for key in ("k", "v")}

        return {"units": {f"b{i}_{k}": state(k, n_units) for i, k in enumerate(g.pattern)},
                "tail": [state(g.pattern[i]) for i in range(n_tail)]}

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
    """Logits ``(B, S, vocab)`` for the S tokens and the advanced cache.
    A ``hybrid`` config's decode takes one token a step (S = 1), as the
    reference's does; a ``vlm`` step is the dense one."""
    _check_family(cfg)
    x = embed_lookup(tokens, params["embed"]).to(cfg.adt())
    x = shard(x, "batch", None, "act_embed")
    B, S = tokens.shape
    if cfg.family == "ssm":
        states = []
        for i, lp in enumerate(unbind_layers(params["layers"], cfg.num_layers)):
            x, st = rwkv_block(x, lp, cfg, state=layer(cache, i))
            states.append(st)
        return _head(params, x, cfg), _stack(states)
    # S tokens at consecutive positions from idx
    q_pos = (idx + torch.arange(S, device=x.device)).expand(B, S)
    if cfg.family == "hybrid":  # one token at a time: the rolling window
        pat = cfg.griffin.pattern
        n_units, _ = _hybrid_units(cfg)
        units = []
        for u, lp in enumerate(unbind_layers(params["units"], n_units)):
            lc = layer(cache["units"], u)
            new_lc = {}
            for i, k in enumerate(pat):
                key = f"b{i}_{k}"
                x, new_lc[key] = griffin_layer(x, lp[key], cfg, k, q_pos, state=lc[key], pos=idx)
            units.append(new_lc)
        tail = []
        for i, lp in enumerate(params.get("tail", [])):
            x, st = griffin_layer(x, lp, cfg, pat[i], q_pos, state=cache["tail"][i], pos=idx)
            tail.append(st)
        return _head(params, x, cfg), {"units": _stack(units), "tail": tail}

    def stack_step(x, key, n_layers, use_moe):
        states = []
        for i, lp in enumerate(unbind_layers(params[key], n_layers)):
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            a, nc = _attend(h, lp, cfg, q_pos, cache=layer(cache[key], i), cache_idx=idx)
            x = shard(x + a, "batch", "seq", "act_embed")
            h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
            m = moe_block(h, lp["mlp"], cfg)[0] if use_moe else glu(h, lp["mlp"],
                                                                     act=cfg.mlp_act)
            x = shard(x + m, "batch", "seq", "act_embed")
            states.append(nc)
        return x, _stack(states)

    new_cache = {}
    n_dense = _dense_layers(cfg)
    if n_dense:
        x, new_cache["dense_layers"] = stack_step(x, "dense_layers", n_dense, False)
    x, new_cache["layers"] = stack_step(x, "layers", cfg.num_layers - n_dense,
                                        cfg.family == "moe")
    return _head(params, x, cfg), new_cache
