"""Mixture-of-Experts with capacity-based sorted dispatch (the port of
``repro.models.moe``).

Per routing group (capacity C = ceil(Tg·k/E · cf), at least 4, a multiple
of 4): router → top-k ids and gates → stable argsort by expert id → rank
in expert from the ``searchsorted`` offsets → keep = rank < C (overflow
drops) → (E, C) token-index buffer → gather → the three expert products →
gate-weighted scatter-add back.  The reference's arithmetic, with these
choices on the card:

* ``jax.lax.top_k`` takes the lower index first among equal values, and
  ``torch.topk`` promises no order among ties, so the top k are the first
  k of a stable descending sort;
* the reference scatters the kept rows into the buffers and sends every
  dropped row to one dump slot, where on CUDA any of the duplicates may
  win; here slot (e, c) gathers sorted row ``offsets[e] + c`` if
  ``c < counts[e]``, so no write has a duplicate;
* the dispatch gather and the combine's scatter-add go through
  :func:`..kernels.ops.ordered_gather` and
  :func:`..kernels.ops.ordered_scatter_rows`, which add in operand order
  (forward of the combine, backward of the dispatch) as XLA's scatter
  does, where CUDA's ``index_add_`` adds with atomics in any order.  An
  empty slot's index lies out of range: it gathers zeros and its row is
  dropped from the combine.  The reference gathers the pad token's zero
  row and adds it into the pad token's row, which it slices away; the
  tokens' rows are the same sums, without the pad's chain of up to E·C
  zero rows.

No host synchronisation anywhere in the block (no ``.item()``, no
``nonzero``, no data-dependent shapes), so a decode step that runs it
records into a CUDA graph.  Products are float32 (TF32 off), as the
reference's ``preferred_element_type=float32``; ``h`` is cast to
``x.dtype`` before ``wd`` and the combine adds in ``x.dtype``.  The
reference's ``shard(...)`` layout hints are left out (ROADMAP queue 1,
'Sharding').
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import glu, glu_decls
from .params import ParamDecl


def moe_decls(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    decls = {
        "router": ParamDecl((d, m.num_experts), ("embed", "experts"), scale=0.02),
        "wg": ParamDecl((m.num_experts, d, m.expert_ff), ("experts", "expert_embed", "expert_ff")),
        "wu": ParamDecl((m.num_experts, d, m.expert_ff), ("experts", "expert_embed", "expert_ff")),
        "wd": ParamDecl((m.num_experts, m.expert_ff, d), ("experts", "expert_ff", "expert_embed")),
    }
    if m.shared_experts:
        decls["shared"] = glu_decls(d, m.shared_ff or m.shared_experts * m.expert_ff)
    return decls


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = math.ceil(tokens_per_group * m.top_k / m.num_experts * m.capacity_factor)
    return max(4, -(-c // 4) * 4)  # ≥4, rounded up to a multiple of 4


class Routing(NamedTuple):
    """One block's routing: ``ids`` (G, Tg, K) experts a token picked;
    ``buf_tok`` (G, E, C) the token in each slot (``Tg`` for an empty
    one); ``buf_gate`` (G, E, C) float32 its gate (0 when empty); ``aux``
    the load-balance loss."""

    ids: torch.Tensor
    buf_tok: torch.Tensor
    buf_gate: torch.Tensor
    aux: torch.Tensor


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Routing of ``xt`` (G, Tg, D), the reference's steps."""
    m = cfg.moe
    G, Tg, _ = xt.shape
    E, K = m.num_experts, m.top_k
    C = capacity(Tg, cfg)
    dev = xt.device

    logits = torch.matmul(xt.float(), router.float())  # (G, Tg, E), float32
    probs = torch.softmax(logits * m.router_scale, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)  # lower index first on ties
    gates, ids = top.values[..., :K], top.indices[..., :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=1)  # (G, E)

    flat_ids = ids.reshape(G, Tg * K)
    flat_tok = torch.arange(Tg, device=dev).repeat_interleave(K)
    flat_gate = gates.reshape(G, Tg * K).float()
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sids = torch.gather(flat_ids, 1, order)
    stok = flat_tok[order]
    sgate = torch.gather(flat_gate, 1, order)

    # each expert's first sorted row (searchsorted side="left") and its rows
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    offsets = torch.searchsorted(sids, experts)
    counts = torch.diff(offsets, dim=-1, append=torch.full((G, 1), Tg * K, device=dev))
    frac = counts.float() / (Tg * K)
    aux = E * torch.mean(torch.sum(frac * me, dim=-1))

    # slot (e, c) holds sorted row offsets[e] + c when c < counts[e]
    slot = torch.arange(C, device=dev)
    filled = slot < counts[..., None]  # (G, E, C)
    pos = torch.clamp(offsets[..., None] + slot, max=Tg * K - 1).reshape(G, E * C)
    buf_tok = torch.where(filled, torch.gather(stok, 1, pos).reshape(G, E, C), Tg)
    buf_gate = torch.where(filled, torch.gather(sgate, 1, pos).reshape(G, E, C), 0.0)
    return Routing(ids, buf_tok, buf_gate, aux)


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux load-balance loss, float32 scalar)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    G = m.groups if T % m.groups == 0 else 1
    Tg = T // G
    E = m.num_experts
    C = capacity(Tg, cfg)

    xt = x.reshape(G, Tg, D)
    r = route(xt, p["router"], cfg)

    # rows of the flattened (G·Tg, D) tokens; an empty slot's lies out of range
    base = (torch.arange(G, device=x.device) * Tg)[:, None, None]
    rows = torch.where(r.buf_tok < Tg, r.buf_tok + base, G * Tg).reshape(G * E * C)
    xg = ops.ordered_gather(xt.reshape(G * Tg, D), rows).reshape(G, E, C, D)

    xg32 = xg.float()
    h_g = torch.einsum("gecd,edf->gecf", xg32, p["wg"].float())
    h_u = torch.einsum("gecd,edf->gecf", xg32, p["wu"].float())
    h = F.silu(h_g) * h_u
    y = torch.einsum("gecf,efd->gecd", h.to(x.dtype).float(), p["wd"].float()).to(x.dtype)
    y = y * r.buf_gate[..., None].to(y.dtype)

    out = ops.ordered_scatter_rows(G * Tg, rows, y.reshape(G * E * C, D)).reshape(G, Tg, D)
    if "shared" in p:
        out = out + glu(xt, p["shared"])
    return out.reshape(B, S, D), r.aux
