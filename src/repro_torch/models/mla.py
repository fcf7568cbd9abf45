"""Multi-head Latent Attention (DeepSeek-V3) with a compressed-KV decode
cache (the port of ``repro.models.mla``).

Training and prefill without a cache expand K/V from the latent; decode and
the chunked prefill through the cache use the *absorbed* form: q_nope is
folded through the k-up projection so the scores read the (kv_lora)-wide
latent cache directly, and values are rebuilt only after the softmax:

  scores  = (q_nope · W_k_up) · c_kv  +  q_rope · k_rope
  out     = (softmax · c_kv) · W_v_up

The cache a token is kv_lora + rope_dim (576 for V3) instead of 2·H·head_dim.
Plain torch ops with the reference's arithmetic: float32 products cast back
as the reference casts them, a float32 softmax, masks filled with
``NEG_INF`` (not ``-inf``).  The reference's ``shard`` / ``replicate`` /
``shard_decode_logits`` layout hints are left out (ROADMAP queue 1,
'Sharding').
"""
from __future__ import annotations

import torch

from .attention import FLASH_MIN_KV, NEG_INF, _out, _project, blockwise_mha, cache_write
from .config import ModelConfig
from .layers import apply_rope, matmul, rmsnorm, rope_angles
from .params import ParamDecl


def mla_decls(cfg: ModelConfig) -> dict:
    m = cfg.mla
    H, D = cfg.num_heads, cfg.d_model
    qk = m.nope_dim + m.rope_dim
    return {
        "wq_down": ParamDecl((D, m.q_lora), ("embed", "lora")),
        "q_ln": ParamDecl((m.q_lora,), ("lora",), init="ones"),
        "wq_up": ParamDecl((m.q_lora, H, qk), ("lora", "heads", "qk_head_dim")),
        "wkv_down": ParamDecl((D, m.kv_lora + m.rope_dim), ("embed", "lora")),
        "kv_ln": ParamDecl((m.kv_lora,), ("lora",), init="ones"),
        "wk_up": ParamDecl((m.kv_lora, H, m.nope_dim), ("lora", "heads", "qk_head_dim")),
        "wv_up": ParamDecl((m.kv_lora, H, m.v_dim), ("lora", "heads", "v_head_dim")),
        "wo": ParamDecl((H, m.v_dim, D), ("heads", "v_head_dim", "embed")),
    }


def _project_q(x, p, cfg):
    m = cfg.mla
    cq = rmsnorm(matmul(x, p["wq_down"]), p["q_ln"], cfg.norm_eps)
    q = _project(cq, p["wq_up"])  # (B, S, H, nope + rope)
    return q[..., : m.nope_dim], q[..., m.nope_dim :]


def _project_kv_latent(x, p, cfg, q_pos):
    m = cfg.mla
    ckv_full = matmul(x, p["wkv_down"])
    ckv = rmsnorm(ckv_full[..., : m.kv_lora], p["kv_ln"], cfg.norm_eps)
    krope = ckv_full[..., m.kv_lora :]
    cos, sin = rope_angles(q_pos, m.rope_dim, cfg.rope_theta)
    krope = apply_rope(krope[..., None, :], cos, sin)[..., 0, :]
    return ckv, krope


def _causal(q_pos: torch.Tensor, kv_len: int) -> torch.Tensor:
    """(B, 1, S, T) keep-mask: key position ≤ query position."""
    kv_pos = torch.arange(kv_len, device=q_pos.device)
    return (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]


def mla_attention(
    x: torch.Tensor,  # (B, S, D)
    p: dict,
    cfg: ModelConfig,
    q_pos: torch.Tensor,  # (B, S)
    *,
    cache: dict | None = None,  # {"ckv": (B, Smax, kv_lora), "krope": (B, Smax, rope)}
    cache_idx=None,
) -> tuple[torch.Tensor, dict | None]:
    m = cfg.mla
    H = cfg.num_heads
    scale = (m.nope_dim + m.rope_dim) ** -0.5

    q_nope, q_rope = _project_q(x, p, cfg)
    cos, sin = rope_angles(q_pos, m.rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    ckv, krope = _project_kv_latent(x, p, cfg, q_pos)

    if cache is None:
        # training / prefill: K, V expanded from the latent
        k_nope = _project(ckv, p["wk_up"])
        v = _project(ckv, p["wv_up"])
        B, S = x.shape[:2]
        kr = krope[:, :, None, :].expand(B, S, H, m.rope_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, kr.to(k_nope.dtype)], dim=-1)
        if S >= FLASH_MIN_KV:
            # blockwise, no S×S scores; its (nope + rope)**-0.5 is this scale
            out = blockwise_mha(q, k, v, q_pos, causal=True)
        else:
            logits = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) * scale
            logits = torch.where(_causal(q_pos, S), logits, NEG_INF)
            w = torch.softmax(logits, dim=-1).to(v.dtype)
            out = torch.einsum("bnst,btnh->bsnh", w.float(), v.float())
        return _out(out.to(x.dtype), p["wo"]), None

    # decode and chunked prefill: absorbed attention over the latent cache
    ckv_c = cache_write(cache["ckv"], ckv, cache_idx)
    krope_c = cache_write(cache["krope"], krope, cache_idx)
    q_abs = torch.einsum("bsnh,lnh->bsnl", q_nope.float(), p["wk_up"].float()).to(x.dtype)
    logits = (torch.einsum("bsnl,btl->bnst", q_abs.float(), ckv_c.float())
              + torch.einsum("bsnr,btr->bnst", q_rope.float(), krope_c.float())) * scale
    logits = torch.where(_causal(q_pos, ckv_c.shape[1]), logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bnst,btl->bsnl", w.float(), ckv_c.float())
    out = torch.einsum("bsnl,lnh->bsnh", o_lat.to(x.dtype).float(),
                       p["wv_up"].float()).to(x.dtype)
    return _out(out, p["wo"]), {"ckv": ckv_c, "krope": krope_c}
