"""Whisper-style encoder-decoder backbone (the port of
``repro.models.whisper``; arXiv:2212.04356).

The conv/mel frontend is stubbed, as in the reference: the inputs are
precomputed frame embeddings (B, num_frames, d_model), what the two conv
layers would produce.  The transformer backbone: bidirectional encoder
layers, causal decoder layers with cross-attention, GELU MLPs, pre-norm,
sinusoidal positions, tied embedding and output head.

Decode caches: each decoder layer's self-attention K/V (grows with the
generated length) and cross-attention K/V, computed once by
:func:`whisper_prefill` from the encoder.  The sinusoid table is built once
per (length, width, dtype, device) and a decode step takes its row with a
device index, so a step copies nothing from the host and can be captured in
a CUDA graph.  Under a mesh the reference's ``shard`` layout hints stand at
its sites (DTensor layouts; nothing on plain tensors).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import as_device
from ..sharding import shard
from .attention import _project, attention, attn_decls
from .config import ModelConfig
from .layers import embed_decls, embed_lookup, matmul, rmsnorm, softmax_xent
from .params import ParamDecl
from .transformer import _head, _stack, layer, stack_decls, unbind_layers


def _mlp_decls(d: int, ff: int) -> dict:
    return {
        "wi": ParamDecl((d, ff), ("embed", "ff")),
        "wo": ParamDecl((ff, d), ("ff", "embed")),
    }


def _mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = shard(matmul(x, p["wi"]), "batch", None, "ff")
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)  # jax.nn.gelu's default
    return matmul(h, p["wo"])


def _enc_layer_decls(cfg: ModelConfig) -> dict:
    return {
        "ln1": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_decls(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd()),
        "ln2": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        "mlp": _mlp_decls(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_decls(cfg: ModelConfig) -> dict:
    d = _enc_layer_decls(cfg)
    d["lnx"] = ParamDecl((cfg.d_model,), ("embed",), init="ones")
    d["xattn"] = attn_decls(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd())
    return d


def whisper_decls(cfg: ModelConfig) -> dict:
    return {
        "embed": embed_decls(cfg.vocab_size, cfg.d_model),
        "enc_layers": stack_decls(_enc_layer_decls(cfg), cfg.encdec.encoder_layers),
        "enc_ln": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        "dec_layers": stack_decls(_dec_layer_decls(cfg), cfg.num_layers),
        "final_ln": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
    }


@functools.lru_cache(maxsize=32)
def sinusoid_pos(length: int, d: int, dtype: torch.dtype = torch.float32,
                 device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(length, d) sin/cos positions, built in float64 numpy as the
    reference builds them, cast to ``dtype`` and put on ``device`` once."""
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device=device, dtype=dtype)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = frames.to(cfg.adt()) + sinusoid_pos(frames.shape[1], cfg.d_model, cfg.adt(),
                                            frames.device)
    x = shard(x, "batch", "frames", "act_embed")
    B, Fr, _ = x.shape
    pos = torch.arange(Fr, device=x.device).expand(B, Fr)
    for lp in unbind_layers(params["enc_layers"], cfg.encdec.encoder_layers):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attention(h, lp["attn"], cfg, pos, causal=False, use_rope=False)
        x = shard(x + a, "batch", "frames", "act_embed")
        h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = shard(x + _mlp(h, lp["mlp"]), "batch", "frames", "act_embed")
    return rmsnorm(x, params["enc_ln"], cfg.norm_eps)


def _dec_layer(c, lp, cfg, pos, enc_out, self_cache=None, cross_cache=None, idx=None):
    h = rmsnorm(c, lp["ln1"], cfg.norm_eps)
    a, new_self = attention(h, lp["attn"], cfg, pos, causal=True, use_rope=False,
                            cache=self_cache, cache_idx=idx)
    c = shard(c + a, "batch", "seq", "act_embed")
    h = rmsnorm(c, lp["lnx"], cfg.norm_eps)
    a, new_cross = attention(h, lp["xattn"], cfg, pos, use_rope=False, x_kv=enc_out,
                             cache=cross_cache)
    c = shard(c + a, "batch", "seq", "act_embed")
    h = rmsnorm(c, lp["ln2"], cfg.norm_eps)
    return shard(c + _mlp(h, lp["mlp"]), "batch", "seq", "act_embed"), new_self, new_cross


def decode_train(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S, vocab) of the teacher-forced decoder over ``enc_out``."""
    B, S = tokens.shape
    y = embed_lookup(tokens, params["embed"]).to(cfg.adt())
    y = y + sinusoid_pos(S, cfg.d_model, y.dtype, y.device)[None]
    y = shard(y, "batch", "seq", "act_embed")
    pos = torch.arange(S, device=y.device).expand(B, S)
    for lp in unbind_layers(params["dec_layers"], cfg.num_layers):
        y, _, _ = _dec_layer(y, lp, cfg, pos, enc_out)
    return _head(params, y, cfg)


def whisper_loss(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    enc_out = encode(params, batch["frames"], cfg)
    logits = decode_train(params, batch["tokens"], enc_out, cfg)
    loss = softmax_xent(logits[:, :-1, :], batch["labels"][:, 1:])
    return loss, {"xent": loss}


def whisper_init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                       device: str | torch.device = "cuda",
                       dtype: torch.dtype | None = None) -> dict:
    """Zeros: ``self`` k/v of (layers, B, max_seq, KVH, hd) and ``cross``
    k/v of (layers, B, num_frames, KVH, hd), in ``cfg.adt()``."""
    dev = as_device(device)
    dtype = dtype or cfg.adt()
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd()

    def kv(length):
        return {key: torch.zeros((L, batch, length, KVH, hd), dtype=dtype, device=dev)
                for key in ("k", "v")}

    return {"self": kv(max_seq), "cross": kv(cfg.encdec.num_frames)}


def whisper_prefill(params: dict, frames: torch.Tensor, cache: dict, cfg: ModelConfig) -> dict:
    """Run the encoder and precompute every decoder layer's cross K/V."""
    enc_out = encode(params, frames, cfg)
    ks, vs = [], []
    for lp in unbind_layers(params["dec_layers"], cfg.num_layers):
        ks.append(_project(enc_out, lp["xattn"]["wk"]))
        vs.append(_project(enc_out, lp["xattn"]["wv"]))
    return {"self": cache["self"], "cross": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def whisper_decode_step(params: dict, cache: dict, tokens: torch.Tensor, idx,
                        cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Logits (B, 1, vocab) of one token at position ``idx`` (an int or a
    0-d device tensor) and the cache with its self K/V written."""
    B = tokens.shape[0]
    y = embed_lookup(tokens, params["embed"]).to(cfg.adt())
    length = cache["self"]["k"].shape[2]
    table = sinusoid_pos(length, cfg.d_model, y.dtype, y.device)
    row = (idx + torch.zeros(1, dtype=torch.long, device=y.device)).clamp(0, length - 1)
    y = y + torch.index_select(table, 0, row)[None]
    pos = idx + torch.zeros((B, 1), dtype=torch.long, device=y.device)
    selves = []
    for i, lp in enumerate(unbind_layers(params["dec_layers"], cfg.num_layers)):
        y, new_self, _ = _dec_layer(y, lp, cfg, pos, None, self_cache=layer(cache["self"], i),
                                    cross_cache=layer(cache["cross"], i), idx=idx)
        selves.append(new_self)
    return _head(params, y, cfg), {"self": _stack(selves), "cross": cache["cross"]}
