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
``x.dtype`` before ``wd`` and the combine adds in ``x.dtype``.

Under a mesh the reference's layout hints (``shard``: groups on ``data``,
experts on ``model``) are DTensor layouts, and the block runs on each
rank's groups and experts (:func:`_sharded_experts`), the dispatch and the
combine on local rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels import ops
from ..sharding import shard
from ..sharding.specs import from_local, shard_offsets
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


def _experts(xt: torch.Tensor, r: Routing, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """Experts ``lo .. lo + len(wg) - 1`` of routing ``r`` over ``xt`` (G,
    Tg, D): dispatch gather → the three products → gate-weighted combine,
    (G, Tg, D) in ``xt.dtype``."""
    G, Tg, D = xt.shape
    El = wg.shape[0]
    buf_tok, buf_gate = r.buf_tok[:, lo:lo + El], r.buf_gate[:, lo:lo + El]
    C = buf_tok.shape[-1]
    # rows of the flattened (G·Tg, D) tokens; an empty slot's lies out of range
    base = (torch.arange(G, device=xt.device) * Tg)[:, None, None]
    rows = torch.where(buf_tok < Tg, buf_tok + base, G * Tg).reshape(G * El * C)
    xg = ops.ordered_gather(xt.reshape(G * Tg, D), rows).reshape(G, El, C, D)
    xg = shard(xg, "groups", "experts", "capacity", None)

    xg32 = xg.float()
    h_g = torch.einsum("gecd,edf->gecf", xg32, wg.float())
    h_u = torch.einsum("gecd,edf->gecf", xg32, wu.float())
    h = F.silu(h_g) * h_u
    y = torch.einsum("gecf,efd->gecd", h.to(xt.dtype).float(), wd.float()).to(xt.dtype)
    y = y * buf_gate[..., None].to(y.dtype)
    y = shard(y, "groups", "experts", "capacity", None)
    return ops.ordered_scatter_rows(G * Tg, rows, y.reshape(G * El * C, D)).reshape(G, Tg, D)


def _sharded_experts(xt: DTensor, p: dict, cfg: ModelConfig) -> tuple[DTensor, DTensor]:
    """Routing and experts of DTensor tokens ``xt`` (G, Tg, D) on each rank's
    groups and experts.  Mesh dims that shard the groups ("G dims") split
    the tokens; mesh dims that shard the experts' weights ("E dims") split
    the experts: each rank routes its groups over all E experts (the router
    replicated), dispatches to its own experts' rows and combines them, so
    the result is ``Partial`` over the E dims and the kernels see local
    tensors only.  Everything a rank computes is its share of the sum over
    the E dims (the aux loss a ``1/|E dims|`` part), so the tokens' and
    router's gradients are ``Partial`` there and on the G dims, and the
    experts' weights' gradients ``Partial`` on the G dims."""
    mesh = xt.device_mesh
    n = mesh.ndim
    xt = xt.redistribute(mesh, [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                                for pl in xt.placements])
    w_pl = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in p["wg"].placements]
    g_dims = {i for i, pl in enumerate(xt.placements) if isinstance(pl, Shard)}
    e_dims = {i for i, pl in enumerate(w_pl) if isinstance(pl, Shard)}
    if g_dims & e_dims:
        raise ValueError("one mesh dim cannot shard both the MoE groups and the experts")
    n_g = math.prod(mesh.size(i) for i in g_dims)
    n_e = math.prod(mesh.size(i) for i in e_dims)

    def part(i, other):
        return Partial() if i in e_dims or i in g_dims else other

    xt_l = xt.to_local(grad_placements=[Partial() if i in e_dims else xt.placements[i]
                                        for i in range(n)])
    router = p["router"].redistribute(mesh, [Replicate()] * n)
    router_l = router.to_local(grad_placements=[part(i, Replicate()) for i in range(n)])
    w_l = [p[k].redistribute(mesh, w_pl).to_local(
        grad_placements=[Partial() if i in g_dims else w_pl[i] for i in range(n)])
        for k in ("wg", "wu", "wd")]
    lo = shard_offsets(p["wg"].shape, mesh, w_pl)[1][0]
    r = route(xt_l, router_l, cfg)
    out_l = _experts(xt_l, r, *w_l, lo=lo)
    out = from_local(out_l, mesh, [Partial() if i in e_dims else xt.placements[i]
                                   for i in range(n)], xt.shape)
    aux = from_local(r.aux / (n_g * n_e), mesh, [part(i, Replicate()) for i in range(n)], ())
    return out, aux


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux load-balance loss, float32 scalar)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    G = m.groups if T % m.groups == 0 else 1
    Tg = T // G

    xt = shard(x.reshape(G, Tg, D), "groups", None, None)
    if isinstance(xt, DTensor):
        out, aux = _sharded_experts(xt, p, cfg)
    else:
        r = route(xt, p["router"], cfg)
        out, aux = _experts(xt, r, p["wg"], p["wu"], p["wd"]), r.aux
    out = shard(out, "groups", None, None)
    if "shared" in p:
        out = out + glu(xt, p["shared"])
    return out.reshape(B, S, D), aux
