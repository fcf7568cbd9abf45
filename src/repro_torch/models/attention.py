"""GQA / MQA attention: training (full-sequence causal), decode (KV cache),
cross-attention (the port of ``repro.models.attention``).

One implementation covers the zoo's attention variants:
  * grouped-query attention, any H/KVH ratio (MQA included);
  * optional per-head qk RMS-norm (qwen3), QKV bias (qwen2 / qwen1.5);
  * sliding-window masks;
  * cross-attention with precomputed encoder KV;
  * decode writing S tokens into a (B, S_max, KVH, hd) cache.

Plain torch ops that mirror the reference's arithmetic: float32 products of
the activations (``preferred_element_type=float32``), a float32 softmax cast
to ``v.dtype``, masks filled with ``NEG_INF`` (not ``-inf``).  The
reference's layout hints (``shard``, ``replicate``, ``shard_cache_kv``,
``shard_decode_logits``) stand at its sites: DTensor layouts under a mesh,
nothing on plain tensors.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Shard

from ..kernels.ops import is_dtensor
from ..sharding import replicate, shard, shard_cache_kv, shard_decode_logits
from ..sharding.specs import local_apply, shard_offsets
from .config import ModelConfig
from .layers import apply_rope, matmul, rmsnorm, rope_angles
from .params import ParamDecl

NEG_INF = -2.0e38
FLASH_MIN_KV = 8192  # blockwise path kicks in for long-context prefill


def attn_decls(
    d_model: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    qkv_bias: bool = False,
    qk_norm: bool = False,
) -> dict:
    d = {
        "wq": ParamDecl((d_model, num_heads, head_dim), ("embed", "heads", "qk_head_dim")),
        "wk": ParamDecl((d_model, num_kv_heads, head_dim), ("embed", "kv_heads", "qk_head_dim")),
        "wv": ParamDecl((d_model, num_kv_heads, head_dim), ("embed", "kv_heads", "v_head_dim")),
        "wo": ParamDecl((num_heads, head_dim, d_model), ("heads", "v_head_dim", "embed")),
    }
    if qkv_bias:
        d["bq"] = ParamDecl((num_heads, head_dim), ("heads", "qk_head_dim"), init="zeros")
        d["bk"] = ParamDecl((num_kv_heads, head_dim), ("kv_heads", "qk_head_dim"), init="zeros")
        d["bv"] = ParamDecl((num_kv_heads, head_dim), ("kv_heads", "v_head_dim"), init="zeros")
    if qk_norm:
        d["q_norm"] = ParamDecl((head_dim,), ("qk_head_dim",), init="ones")
        d["k_norm"] = ParamDecl((head_dim,), ("qk_head_dim",), init="ones")
    return d


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``bsd,dnh->bsnh``.  On a mesh with a dim that does not divide the n
    heads the product runs on each rank's rows of ``x`` with ``w`` whole
    (``sharding.specs.local_apply``): DTensor may shard the product's n·h
    columns over that dim, and then cannot unflatten them, nor their
    gradient, into (n, h)."""
    d, n, h = w.shape
    if is_dtensor(w) and any(n % s for s in w.device_mesh.shape):
        B, S = x.shape[:2]
        rows = {0: "batch", 1: "seq"}
        return local_apply(lambda xl, wl: _project(xl, wl), [x, w], [rows, {}], [rows],
                           [(B, S, n, h)])
    return matmul(x, w.reshape(d, n * h)).reshape(*x.shape[:-1], n, h)


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``bsnh,nhd->bsd``."""
    n, h, d = w.shape
    return matmul(o.reshape(*o.shape[:-2], n * h), w.reshape(n * h, d))


def cache_write(cache: torch.Tensor, new: torch.Tensor, idx) -> torch.Tensor:
    """``cache`` (B, T, ...) with ``new`` (B, S, ...) written at [idx, idx+S).

    The reference's one-hot (S = 1) and windowed (S > 1) select, not an
    in-place slice write, so the new cache is the reference's bit for bit.
    """
    T = cache.shape[1]
    S = new.shape[1]
    pos = torch.arange(T, device=cache.device)
    shape = (1, T) + (1,) * (cache.ndim - 2)
    if S == 1:
        return torch.where((pos == idx).reshape(shape), new.to(cache.dtype), cache)
    within = (pos >= idx) & (pos < idx + S)
    src = torch.clamp(pos - idx, 0, S - 1)
    gathered = torch.index_select(new.to(cache.dtype), 1, src)
    return torch.where(within.reshape(shape), gathered, cache)


def _mask(
    q_pos: torch.Tensor,  # (B, S) int
    kv_len: int,
    causal: bool,
    window: int | None,
) -> torch.Tensor:
    """(B, S, T) boolean keep-mask."""
    kv_pos = torch.arange(kv_len, device=q_pos.device)
    keep = torch.ones((q_pos.shape[0], q_pos.shape[1], kv_len), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        keep = keep & (kv_pos[None, None, :] <= q_pos[:, :, None])
    if window is not None:
        keep = keep & (kv_pos[None, None, :] > q_pos[:, :, None] - window)
    return keep


def mha(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, KVH, hd)
    v: torch.Tensor,  # (B, T, KVH, hd)
    keep: torch.Tensor | None,  # (B, S, T) or None (full attention)
    grouped: bool = False,
) -> torch.Tensor:
    """Attention core; float32 softmax; returns (B, S, H, hd) in ``v.dtype``.

    Two GQA strategies, as the reference picks them: prefill and training
    (``grouped=False``) expand the KV heads to the query heads; decode
    (``grouped=True``) contracts grouped queries against the compact cache.
    DTensor inputs run on each rank's rows and heads (:func:`local_heads`).
    """
    if is_dtensor(q):
        return local_heads(mha, q, k, v, keep, grouped=grouped)
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    if grouped and H != KVH:
        g = H // KVH
        # decode queries are tiny; replicate them so their head sharding
        # cannot force a gather of the sequence-sharded cache
        qg = replicate(q).reshape(B, S, KVH, g, hd)
        logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * (hd**-0.5)
        logits = shard_decode_logits(logits, heads_dim=1, seq_dim=4)
        if keep is not None:
            logits = torch.where(keep[:, None, None, :, :], logits, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", w.float(), v.float()).reshape(B, S, H, hd)
        return out.to(v.dtype)
    if H != KVH:
        g = H // KVH
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    logits = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) * (hd**-0.5)
    if grouped:  # decode: stay consistent with the cache layout
        logits = shard_decode_logits(logits, heads_dim=1, seq_dim=3)
    else:
        logits = shard(logits, "batch", "heads", None, "kv_seq")
    if keep is not None:
        logits = torch.where(keep[:, None, :, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bnst,btnh->bsnh", w.float(), v.float())
    return out.to(v.dtype)


def blockwise_mha(
    q: torch.Tensor,  # (B, S, H, hd), heads already expanded to match k/v
    k: torch.Tensor,  # (B, T, H, hd)
    v: torch.Tensor,  # (B, T, H, hd_v)
    q_pos: torch.Tensor,  # (B, S)
    *,
    causal: bool = True,
    window: int | None = None,
    block: int = 1024,
) -> torch.Tensor:
    """Flash-style attention: a loop over KV blocks with a running (max, sum,
    acc) in float32, so the S×T score matrix never materialises.  Equal to
    softmax(QKᵀ)V up to float32 association; DTensor inputs run on each
    rank's rows and heads (:func:`local_heads`)."""
    if is_dtensor(q):
        return local_heads(blockwise_mha, q, k, v, q_pos, causal=causal, window=window,
                           block=block)
    B, S, H, hd = q.shape
    T = k.shape[1]
    hd_v = v.shape[-1]
    blk = min(block, T)
    Tp = (T + blk - 1) // blk * blk
    pad = Tp - T
    if pad:
        k = torch.cat([k, k.new_zeros((B, pad, H, hd))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad, H, hd_v))], dim=1)
    scale = hd**-0.5
    dev = q.device
    m = torch.full((B, H, S), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, S, hd_v), dtype=torch.float32, device=dev)
    qf = q.float()
    for start in range(0, Tp, blk):
        kblk, vblk = k[:, start:start + blk], v[:, start:start + blk]
        pos = torch.arange(start, start + blk, device=dev)
        s = torch.einsum("bsnh,btnh->bnst", qf, kblk.float()) * scale  # (B, H, S, blk)
        keep = pos[None, None, :] < T
        if causal:
            keep = keep & (pos[None, None, :] <= q_pos[:, :, None])
        if window is not None:
            keep = keep & (pos[None, None, :] > q_pos[:, :, None] - window)
        s = torch.where(keep[:, None, :, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        r = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * r + p.sum(dim=-1)
        acc = acc * r[..., None] + torch.einsum(
            "bnst,btnh->bnsh", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(v.dtype)  # (B, S, H, hd_v)


def local_heads(core, q, k, v, mask, **kw):
    """``core(q, k, v, mask, **kw)``, an attention core over (B, S, H, d)
    DTensor queries and (B, T, KVH, d) keys and values, on each rank's batch
    rows and query heads (``sharding.specs.local_apply``): attention keeps
    rows and heads apart, and an einsum that merges a sharded head dim with
    the batch has no DTensor strategy (torch 2.11).  The keys and values
    follow the query heads where the mesh splits both alike; else each
    rank takes whole the key/value head of each of its query heads.  A
    decode over a sequence-sharded KV cache runs on each rank's slice of
    the sequence instead (:func:`_seq_sharded_decode`)."""
    mesh = q.device_mesh
    if kw.get("grouped") and any(isinstance(p, Shard) and p.dim == 1 for p in k.placements):
        return _seq_sharded_decode(q, k, v, mask)
    B, S, H, _ = q.shape
    KVH = k.shape[2]
    heads = [i for i, p in enumerate(q.placements) if isinstance(p, Shard) and p.dim == 2]
    n = math.prod(mesh.size(i) for i in heads)
    bh, b = {0: "batch", 2: "heads"}, {0: "batch"}
    if KVH % n == 0:
        def fn(ql, kl, vl, ml):
            return core(ql, kl, vl, ml, **kw)
        kv = bh
    else:
        h0 = shard_offsets(q.shape, mesh, q.placements)[1][2]
        idx = torch.div(h0 + torch.arange(H // n, device=q.device), H // KVH,
                        rounding_mode="floor")

        def fn(ql, kl, vl, ml):
            return core(ql, kl.index_select(2, idx), vl.index_select(2, idx), ml, **kw)
        kv = b
    return local_apply(fn, [q, k, v, mask], [bh, kv, kv, b], [bh], [(B, S, H, v.shape[-1])])


def _seq_sharded_decode(q, k, v, keep):
    """Grouped decode attention over a KV cache sharded along its sequence,
    as GSPMD partitions the reference's (flash-decode): the queries are
    replicated over the mesh dims that shard the sequence, each rank scores
    its slice of the cache, and the softmax's max and sum and the weighted
    values are all-reduced over those dims, so no rank gathers the cache."""
    import torch.distributed._functional_collectives as funcol

    mesh = k.device_mesh
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    g = H // KVH
    seq = [i for i, p in enumerate(k.placements) if isinstance(p, Shard) and p.dim == 1]

    def reduce(t, op):
        for i in seq:
            t = funcol.all_reduce(t, op, (mesh, i))
        return funcol.wait_tensor(t) if seq else t

    def fn(kl, vl, ql, ml):
        b, s = ql.shape[:2]
        qg = ql.reshape(b, s, KVH, g, hd)
        logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), kl.float()) * (hd**-0.5)
        if ml is not None:
            logits = torch.where(ml[:, None, None, :, :], logits, NEG_INF)
        m = reduce(logits.amax(dim=-1, keepdim=True), "max")
        e = torch.exp(logits - m)
        w = (e / reduce(e.sum(dim=-1, keepdim=True), "sum")).to(vl.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", w.float(), vl.float())
        return reduce(out, "sum").reshape(b, s, H, hd).to(vl.dtype)

    bt = {0: "batch", 1: "seq"}
    return local_apply(fn, [k, v, q, keep], [bt, bt, {0: "batch"}, {0: "batch", 2: "seq"}],
                       [{0: "batch"}], [(B, S, H, v.shape[-1])])


def attention(
    x: torch.Tensor,  # (B, S, D)
    p: dict,
    cfg: ModelConfig,
    q_pos: torch.Tensor,  # (B, S) absolute positions
    *,
    causal: bool = True,
    window: int | None = None,
    use_rope: bool = True,
    x_kv: torch.Tensor | None = None,  # cross-attention source (B, T, D)
    cache: dict | None = None,  # {"k", "v"}: (B, S_max, KVH, hd)
    cache_idx=None,  # write position of x's first token
) -> tuple[torch.Tensor, dict | None]:
    hd = cfg.hd()
    q = _project(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)

    if cache is not None and cache_idx is None:
        # cross-attention decode: KV was precomputed at prefill, reused as is
        k, v = cache["k"], cache["v"]
        new_cache = cache
        keep = None
    else:
        src = x if x_kv is None else x_kv
        k = _project(src, p["wk"])
        v = _project(src, p["wv"])
        if "bk" in p:
            k = k + p["bk"].to(k.dtype)
            v = v + p["bv"].to(v.dtype)
        if "k_norm" in p:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
        if use_rope and x_kv is None:
            cos_q, sin_q = rope_angles(q_pos, hd, cfg.rope_theta)
            q = apply_rope(q, cos_q, sin_q)
            k = apply_rope(k, cos_q, sin_q)  # self-attention: the same positions
        k = shard(k, "batch", "seq", "kv_heads", None)
        if cache is not None:
            # self-attention decode: this step's K/V written at cache_idx
            ck = shard_cache_kv(cache_write(cache["k"], k, cache_idx))
            cv = shard_cache_kv(cache_write(cache["v"], v, cache_idx))
            keep = _mask(q_pos, ck.shape[1], causal=True, window=window)
            out = mha(q, ck, cv, keep, grouped=True)
            return _out(out, p["wo"]), {"k": ck, "v": cv}
        new_cache = None
        if x_kv is not None:
            keep = None  # cross-attention training: every frame
        elif causal and k.shape[1] >= FLASH_MIN_KV:
            # long-context prefill and training: blockwise, no S×T scores
            if q.shape[2] != k.shape[2]:
                g = q.shape[2] // k.shape[2]
                k = torch.repeat_interleave(k, g, dim=2)
                v = torch.repeat_interleave(v, g, dim=2)
            q = shard(q, "batch", "seq", "heads", None)
            out = blockwise_mha(q, k, v, q_pos, causal=True, window=window)
            return _out(out, p["wo"]), None
        else:
            keep = _mask(q_pos, k.shape[1], causal=causal, window=window)
    q = shard(q, "batch", "seq", "heads", None)
    out = mha(q, k, v, keep)
    return _out(out, p["wo"]), new_cache
