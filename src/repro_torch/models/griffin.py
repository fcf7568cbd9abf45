"""RecurrentGemma / Griffin blocks (the port of ``repro.models.griffin``):
the RG-LRU recurrence and local sliding-window attention in a 2:1 pattern
(arXiv:2402.19427).

Recurrent block:  x → [linear_y → GeLU] ⊙ [linear_x → causal depthwise conv
(width 4) → RG-LRU] → linear_out.  The RG-LRU gates are block-diagonal (one
block per head, as in the released model):

  r_t = σ(W_a x_t),  i_t = σ(W_x x_t)
  a_t = exp(−c · softplus(Λ) · r_t)
  h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

A prefill or training pass runs the recurrence as the reference's
``jax.lax.associative_scan`` does: the same tree of pairwise combines
(:func:`associative_scan`), about 2·log2(S) strided torch ops, never a loop
over the sequence.  Decode is one O(lru_width) step, a 3-sample conv tail and
a rolling window KV cache.  Plain torch: the reference reaches no kernel. Under a mesh the reference's ``shard`` layout hints stand at its sites
(DTensor layouts; nothing on plain tensors).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from ..kernels.ops import is_dtensor
from ..sharding import shard
from ..sharding.specs import local_apply
from .attention import _out, _project, attention, attn_decls, mha
from .config import ModelConfig
from .layers import apply_rope, glu, glu_decls, matmul, rmsnorm, rope_angles
from .params import ParamDecl

LRU_BLOCKS = 10  # block-diagonal gate heads (recurrentgemma-2b)


def _bdiag_decl(width: int) -> ParamDecl:
    c = width // LRU_BLOCKS
    return ParamDecl((LRU_BLOCKS, c, c), (None, "lru", None), scale=0.02)


def rec_block_decls(cfg: ModelConfig) -> dict:
    g = cfg.griffin
    D, W = cfg.d_model, g.lru_width
    return {
        "wy": ParamDecl((D, W), ("embed", "lru")),
        "wx": ParamDecl((D, W), ("embed", "lru")),
        "conv_w": ParamDecl((g.conv_width, W), ("conv", "lru"), scale=0.1),
        "conv_b": ParamDecl((W,), ("lru",), init="zeros"),
        "gate_a": _bdiag_decl(W),
        "gate_a_b": ParamDecl((W,), ("lru",), init="zeros"),
        "gate_x": _bdiag_decl(W),
        "gate_x_b": ParamDecl((W,), ("lru",), init="zeros"),
        "lam": ParamDecl((W,), ("lru",), init="uniform_pm", scale=1.0),
        "wo": ParamDecl((W, D), ("lru", "embed")),
    }


def _bdiag(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Block-diagonal gate ``bshc,hce->bshe`` in float32, plus the bias.  On
    DTensors each rank computes its rows' and blocks' gates
    (``sharding.specs.local_apply``): the width splits into blocks and
    merges back on local tensors, since a merge after a product sharded
    inside a block has no DTensor strategy (torch 2.11).  A width whose
    shards do not align with the blocks is made whole first."""
    B, S, W = x.shape

    def gate(xl, wl, bl):
        h = xl.reshape(*xl.shape[:2], wl.shape[0], W // LRU_BLOCKS)
        y = torch.einsum("bshc,hce->bshe", h.float(), wl.float())
        return y.reshape(xl.shape) + bl.float()

    if not is_dtensor(x):
        return gate(x, w, b)
    mesh = x.device_mesh
    split = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                      if isinstance(p, Shard) and p.dim == 2)
    if LRU_BLOCKS % split:
        x = x.redistribute(mesh, [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
                                  for p in x.placements])
    blocks = {0: "batch", 2: "blocks"}
    return local_apply(gate, [x, w, b], [blocks, {0: "blocks"}, {0: "blocks"}], [blocks],
                       [(B, S, W)])


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            tail: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv of width K in ``x.dtype``, its taps added in the
    reference's order; ``tail`` (B, K-1, W) is the decode carry.  Returns the
    output and the new tail."""
    K = w.shape[0]
    if tail is None:
        prev = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        prev = tail.to(x.dtype)
    xp = torch.cat([prev, x], dim=1)  # (B, S+K-1, W)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[K - 1 - i].to(x.dtype) for i in range(K))
    return out + b.to(x.dtype), xp[:, -(K - 1):, :]


def _combine(a1, b1, a2, b2):
    """The linear recurrence's combine: (a1, b1) then (a2, b2)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1 (``even`` as long as
    ``odd`` or one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1) if even.shape[1] > n else pairs


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan of :func:`_combine` along dim 1, by JAX 0.9.0's
    ``associative_scan`` tree: combine adjacent pairs, scan the half-length
    result recursively (the odd outputs), combine those with the even inputs
    from index 2 (the even outputs), put element 0 in front and interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rg_lru(
    x: torch.Tensor,  # (B, S, W) float32
    p: dict,
    c_scale: float,
    h0: torch.Tensor | None,  # (B, W) float32 decode carry
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every step's state (B, S, W) and the last (B, W), float32."""
    r = torch.sigmoid(_bdiag(x, p["gate_a"], p["gate_a_b"]))
    i = torch.sigmoid(_bdiag(x, p["gate_x"], p["gate_x_b"]))
    lam = p["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    log_a = -c_scale * softplus * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * x.float())
    if x.shape[1] == 1 and h0 is not None:
        h = a[:, 0] * h0 + gated[:, 0]
        return h[:, None], h
    if h0 is not None:
        gated = torch.cat([gated[:, :1] + (a[:, 0] * h0)[:, None], gated[:, 1:]], dim=1)
    _, hh = associative_scan(a, gated)
    return hh, hh[:, -1]


def recurrent_block(
    x: torch.Tensor,  # (B, S, D), already normed
    p: dict,
    cfg: ModelConfig,
    state: dict | None = None,  # {"conv": (B, K-1, W), "lru": (B, W)}
) -> tuple[torch.Tensor, dict]:
    g = cfg.griffin
    y = F.gelu(matmul(x, p["wy"]).float(), approximate="tanh")  # jax.nn.gelu's default
    xx = shard(matmul(x, p["wx"]), "batch", "seq", "lru")
    xx, conv_tail = _conv1d(xx, p["conv_w"], p["conv_b"], state["conv"] if state else None)
    h, lru_last = rg_lru(xx.float(), p, g.c_scale, state["lru"] if state else None)
    # the scan's strided slices and interleaves can leave the sequence
    # sharded, which the flattening product below cannot take
    h = shard(h, "batch", "seq", "lru")
    out = matmul((h * y).to(x.dtype), p["wo"])
    return out, {"conv": conv_tail.to(x.dtype), "lru": lru_last}


def griffin_attn_decode(
    x: torch.Tensor,  # (B, 1, D), normed
    p: dict,
    cfg: ModelConfig,
    pos,  # absolute position: an int or a 0-d device tensor
    cache: dict,  # {"k", "v"}: (B, W, KVH, hd) rolling window
) -> tuple[torch.Tensor, dict]:
    """One token against the rolling window: the window shifts left by one,
    this token's K/V enter at its end, and window slots before position 0
    are masked.  Positions are made on the device (no host copy, so a decode
    step can be captured in a CUDA graph)."""
    hd = cfg.hd()
    W = cache["k"].shape[1]
    B = x.shape[0]
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    q_pos = pos + torch.zeros((B, 1), dtype=torch.long, device=x.device)
    cos, sin = rope_angles(q_pos, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    ck = torch.cat([cache["k"][:, 1:], k.to(cache["k"].dtype)], dim=1)
    cv = torch.cat([cache["v"][:, 1:], v.to(cache["v"].dtype)], dim=1)
    kv_pos = pos - W + 1 + torch.arange(W, device=x.device)
    keep = (kv_pos >= 0)[None, None, :].expand(B, 1, W)
    out = mha(q, ck, cv, keep)
    return _out(out, p["wo"]), {"k": ck, "v": cv}


def griffin_layer_decls(cfg: ModelConfig, kind: str) -> dict:
    d = {
        "ln1": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        "ln2": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        "mlp": glu_decls(cfg.d_model, cfg.d_ff),
    }
    if kind == "rec":
        d["rec"] = rec_block_decls(cfg)
    else:
        d["attn"] = attn_decls(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd())
    return d


def griffin_layer(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    kind: str,
    q_pos: torch.Tensor,
    *,
    state: dict | None = None,
    pos=None,
) -> tuple[torch.Tensor, dict | None]:
    """One ``"rec"`` or ``"attn"`` layer and its new decode state (None for
    an attention layer without a cache)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        t_out, new_state = recurrent_block(h, p["rec"], cfg, state)
    elif state is not None:
        t_out, new_state = griffin_attn_decode(h, p["attn"], cfg, pos, state)
    else:
        t_out, _ = attention(h, p["attn"], cfg, q_pos, causal=True, window=cfg.griffin.window)
        new_state = None
    x = shard(x + t_out, "batch", "seq", "act_embed")
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return shard(x + glu(h, p["mlp"], act="gelu"), "batch", "seq", "act_embed"), new_state
