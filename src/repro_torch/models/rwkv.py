"""RWKV-6 "Finch" blocks (the port of ``repro.models.rwkv``): token-shift time
mix with data-dependent decay, and the squared-ReLU channel mix.

Faithful to arXiv:2404.05892: 5-way ddlerp token-shift interpolation with a
rank-32 LoRA, decay w_t = exp(-exp(w0 + tanh(x W1) W2)), per-head bonus u,
GroupNorm over heads after the WKV core, SiLU output gate.  The multi-token
time mix runs the WKV recurrence on the whole (B, S, H, hs) batch through
``ops.wkv6`` (the CUDA kernel on the card); one-token decode keeps the
reference's closed form.  Activations round to ``x.dtype`` where the
reference rounds them. Under a mesh the reference's ``shard`` layout hints stand at its sites
(DTensor layouts; nothing on plain tensors).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ops import is_dtensor
from ..sharding import shard
from ..sharding.specs import local_apply
from .config import ModelConfig
from .layers import matmul, rmsnorm
from .params import ParamDecl

MAA_LORA = 32
GROUPNORM_EPS = 64e-5


def rwkv_block_decls(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    r = cfg.rwkv
    H = D // r.head_size
    ff = cfg.d_ff
    return {
        "ln1": ParamDecl((D,), ("embed",), init="ones"),
        "ln2": ParamDecl((D,), ("embed",), init="ones"),
        "tm": {
            "maa_x": ParamDecl((D,), ("embed",), init="zeros"),
            "maa_wkvrg": ParamDecl((5, D), (None, "embed"), init="zeros"),
            "maa_w1": ParamDecl((D, 5 * MAA_LORA), ("embed", None), scale=0.01),
            "maa_w2": ParamDecl((5, MAA_LORA, D), (None, None, "embed"), scale=0.01),
            "decay": ParamDecl((D,), ("embed",), init="normal", scale=0.5),
            "decay_w1": ParamDecl((D, cfg.rwkv.w_lora), ("embed", "lora"), scale=0.01),
            "decay_w2": ParamDecl((cfg.rwkv.w_lora, D), ("lora", "embed"), scale=0.01),
            "bonus": ParamDecl((H, r.head_size), ("heads", None), scale=0.5),
            "wr": ParamDecl((D, D), ("embed", "lru")),
            "wk": ParamDecl((D, D), ("embed", "lru")),
            "wv": ParamDecl((D, D), ("embed", "lru")),
            "wg": ParamDecl((D, D), ("embed", "lru")),
            "wo": ParamDecl((D, D), ("lru", "embed")),
            "ln_x": ParamDecl((D,), ("embed",), init="ones"),
        },
        "cm": {
            "maa_k": ParamDecl((D,), ("embed",), init="zeros"),
            "maa_r": ParamDecl((D,), ("embed",), init="zeros"),
            "wk": ParamDecl((D, ff), ("embed", "ff")),
            "wv": ParamDecl((ff, D), ("ff", "embed")),
            "wr": ParamDecl((D, D), ("embed", None)),
        },
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} along seq; position 0 takes ``prev`` (decode carry) or zeros."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(x: torch.Tensor, xx: torch.Tensor, p: dict) -> list[torch.Tensor]:
    """RWKV-6 data-dependent token-shift interpolation → 5 mixed streams."""
    B, S, D = x.shape
    base = x + xx * p["maa_x"].to(x.dtype)
    # the 5 streams' LoRA whole on each rank: a shard of its 5·32 columns
    # does not split into the 5 streams
    lora = shard(torch.tanh(matmul(base, p["maa_w1"]).float()), "batch", "seq", None)
    lora = lora.reshape(B, S, 5, MAA_LORA)
    delta = torch.einsum("bsfk,fkd->fbsd", lora, p["maa_w2"].float()).to(x.dtype)
    mix = p["maa_wkvrg"].to(x.dtype)  # (5, D)
    return [x + xx * (mix[i] + delta[i]) for i in range(5)]


def time_mix(
    x: torch.Tensor,  # (B, S, D)
    p: dict,
    cfg: ModelConfig,
    *,
    shift_prev: torch.Tensor | None = None,  # (B, D)
    wkv_state: torch.Tensor | None = None,  # (B, H, K, V) float32
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (out (B, S, D), the last token's x (B, D), WKV state (B, H, K, V))."""
    B, S, D = x.shape
    hs = cfg.rwkv.head_size
    H = D // hs
    xx = _shift(x, shift_prev) - x
    xw, xk, xv, xr, xg = _ddlerp(x, xx, p)

    rr = matmul(xr, p["wr"])
    kk = matmul(xk, p["wk"])
    vv = matmul(xv, p["wv"])
    gg = F.silu(matmul(xg, p["wg"]).float())
    decay_lora = torch.tanh(matmul(xw, p["decay_w1"]).float()).to(x.dtype)
    lw = p["decay"].float() + matmul(decay_lora, p["decay_w2"]).float()
    w = torch.exp(-torch.exp(lw))  # (B, S, D) in (0, 1)

    rh = shard(rr.reshape(B, S, H, hs), "batch", "seq", "heads", None)
    kh = kk.reshape(B, S, H, hs)
    vh = vv.reshape(B, S, H, hs)
    wh = w.reshape(B, S, H, hs)
    bonus = p["bonus"].float()

    if S == 1 and is_dtensor(rh):  # each rank's rows and heads
        bh = {0: "batch", 2: "heads"}
        o, s_new = local_apply(_wkv_step, [rh, kh, vh, wh, bonus, wkv_state],
                               [bh, bh, bh, bh, {0: "heads"}, {0: "batch", 1: "heads"}],
                               [bh, {0: "batch", 1: "heads"}], [(B, 1, H, hs), (B, H, hs, hs)])
    elif S == 1:
        o, s_new = _wkv_step(rh, kh, vh, wh, bonus, wkv_state)
    else:
        o, s_new = ops.wkv6(rh, kh, vh, wh, bonus, wkv_state, chunk)

    # GroupNorm over heads (population variance, learned scale, no bias)
    og = o.reshape(B, S, H, hs)
    mu = og.mean(dim=-1, keepdim=True)
    var = og.var(dim=-1, keepdim=True, unbiased=False)
    og = (og - mu) * torch.rsqrt(var + GROUPNORM_EPS)
    o = og.reshape(B, S, D) * p["ln_x"].float()
    o = (o * gg).to(x.dtype)
    return matmul(o, p["wo"]), x[:, -1, :], s_new


def _wkv_step(r, k, v, w, u, s0):
    """One decode step's WKV in closed form: r, k, v (B, 1, H, K) in the
    activations' dtype, w (B, 1, H, K) and u (H, K) float32, s0 (B, H, K,
    V) float32 or None for zeros → (o (B, 1, H, V), the new state).  kv
    rounds to the activations' dtype, as the reference's product of two
    such arrays does."""
    B, _, H, K = r.shape
    if s0 is None:
        s0 = torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32, device=r.device)
    kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]  # (B, H, K, V)
    o = torch.einsum("bhk,bhkv->bhv", r[:, 0].float(), s0 + u[None, :, :, None] * kv)
    return o[:, None], w[:, 0, :, :, None] * s0 + kv


def channel_mix(
    x: torch.Tensor, p: dict, cfg: ModelConfig, *, shift_prev: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    xx = _shift(x, shift_prev) - x
    xk = x + xx * p["maa_k"].to(x.dtype)
    xr = x + xx * p["maa_r"].to(x.dtype)
    k = shard(matmul(xk, p["wk"]), "batch", "seq", "ff")
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = matmul(k, p["wv"])
    r = torch.sigmoid(matmul(xr, p["wr"]).float())
    return (r * kv.float()).to(x.dtype), x[:, -1, :]


def rwkv_block(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    *,
    state: dict | None = None,  # {"tm_shift", "cm_shift", "wkv"} of this layer
    chunk: int = 32,
) -> tuple[torch.Tensor, dict]:
    tm_prev = state["tm_shift"] if state else None
    cm_prev = state["cm_shift"] if state else None
    wkv_prev = state["wkv"] if state else None
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    attn_out, tm_shift, wkv = time_mix(
        h, p["tm"], cfg, shift_prev=tm_prev, wkv_state=wkv_prev, chunk=chunk
    )
    x = shard(x + attn_out, "batch", "seq", "act_embed")
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    ff_out, cm_shift = channel_mix(h, p["cm"], cfg, shift_prev=cm_prev)
    x = shard(x + ff_out, "batch", "seq", "act_embed")
    return x, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv}


def rwkv_init_state(cfg: ModelConfig, batch: int, device: torch.device) -> dict:
    D = cfg.d_model
    hs = cfg.rwkv.head_size
    H = D // hs
    return {
        "tm_shift": torch.zeros((batch, D), dtype=cfg.adt(), device=device),
        "cm_shift": torch.zeros((batch, D), dtype=cfg.adt(), device=device),
        "wkv": torch.zeros((batch, H, hs, hs), dtype=torch.float32, device=device),
    }
