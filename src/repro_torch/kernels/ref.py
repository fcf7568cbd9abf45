"""Plain PyTorch versions of the port's kernels, and the float folds they share.

Every function here runs on any device: the CPU tests use them as the
kernels' stand-ins, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  They are also the numerics contract of the port.  The
JAX package settles on XLA's CPU backend, and the port's epochs must match
a live JAX run bit for bit, so every float fold below repeats the exact
expression tree XLA compiles.  Three facts about that backend, pinned by
``tests/test_torch_kernels.py``:

* **Contraction.**  XLA's CPU code generator contracts ``a*b + c`` into a
  fused multiply-add inside a fusion.  The K-term bundle cost
  ``Σ_k val_k·price[idx_k]`` is therefore ``v₀p₀`` followed by one FMA per
  further term, and with K = 1 the vector-π surplus ``π − v₀p₀`` is one FMA
  too.  :func:`fma` reproduces a correctly rounded float32 FMA exactly on
  any device (round-to-odd in float64, then one rounding to float32).
* **Block fold.**  ``x.reshape(nb, m, R).sum(axis=1)`` is a left fold only
  for m < 16.  XLA rewrites a reduce longer than 32 into windows of 32
  (the input padded by ``pad//2`` zeros in front), folds each window left
  to right, and reduces the window sums the same way, level by level.  A
  reduce of 16..32 values that is fused with the one-hot row producer
  (R ≤ 128) over users that needed no zero padding is vectorized eight
  lanes wide with two accumulators (:func:`_vector_fold`); with padding
  rows it stays a left fold.  :func:`block_fold` is that tree.
* **Cost folds with K ≥ 16** vectorize in yet another pattern; the port
  keeps the FMA left fold there, float-close to XLA, not bit-identical.

The dense book (``bid_eval``, :func:`dense_costs`, :func:`dense_fold`) has
two folds of its own, pinned by ``tests/test_torch_dense.py``:

* **Dense cost fold.**  ``einsum("ubr,r->ub")`` stays a dot, emitted as an
  elemental loop ``acc += b·p`` that LLVM contracts into FMAs.  For
  R < :data:`DENSE_LANE_FOLD_MIN_R` the loop stays scalar: a left FMA fold
  from 0 over all R terms (zero terms leave it unchanged, so it equals the
  sparse K-term fold of the same bundle).  From R = 60 LLVM vectorizes the
  loop with reassociation and the backend rechains the FMAs in an order
  that changes with R; the port does not follow it there.  It folds R ≥ 60
  in 32 strided lanes (lane t takes r = t, t+32, …, one FMA each) and
  halves the lanes (16, 8, 4, 2, 1): the order a warp computes, float-close
  to XLA (see ROADMAP queue 3).
* **Dense z fold.**  ``x.sum(axis=0)`` of the gathered rows is one reduce
  over users fused with the gather.  Up to 15 users it is a left fold, above
  32 the windows of 32 of :func:`block_fold` (left folds, not vectorized);
  from 16 to 32 users LLVM vectorizes the loop, and the tree depends on the
  count (:func:`_dense_vector_fold`).
"""
from __future__ import annotations

import torch

# Below this pool count the reference builds per-user demand rows with
# one-hot compare-and-add passes that XLA fuses into the block reduce (and
# vectorizes); above it rows come from a scatter and the reduce stands alone.
ONEHOT_ROWS_MAX_R = 128
# XLA's tree-reduction window on the CPU backend
FOLD_WINDOW = 32
# From this many pools the dense cost fold runs in 32 strided lanes
DENSE_LANE_FOLD_MIN_R = 60
LANES = 32


# ---------------------------------------------------------------------------
# float32 primitives
# ---------------------------------------------------------------------------


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a*b + c`` (one rounding), on any device.

    The product of two float32 values is exact in float64; the float64 sum is
    then rounded to odd (TwoSum gives the exact error), and rounding a
    round-to-odd value with ≥ 2 spare bits to float32 is the correctly
    rounded result — bit-identical to a hardware FMA and to ``__fmaf_rn``.
    """
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.float()


def cost_fold(val: torch.Tensor, gathered: torch.Tensor) -> torch.Tensor:
    """``Σ_k val_k·gathered_k`` over the last axis: ``v₀p₀`` then one FMA per
    further term, in k order (XLA's contracted fold for K < 16)."""
    acc = val[..., 0] * gathered[..., 0]
    for k in range(1, val.shape[-1]):
        acc = fma(val[..., k], gathered[..., k], acc)
    return acc


def _left_fold(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as ``((0 + x₀) + x₁) + …``."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _halve(v: torch.Tensor) -> torch.Tensor:
    """Sum of the last axis (a power of two) by halving: lane l adds lane
    l + n/2, until one lane is left — a warp's butterfly reduction."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _vector_fold(x: torch.Tensor) -> torch.Tensor:
    """XLA's vectorized fused reduce of n ≤ 32 values (n ≥ 16).

    Two 8-lane accumulators take alternate 8-value chunks of every whole
    16-value step, are added lane-wise, absorb one more 8-value chunk if one
    is left, then reduce across lanes by halving (4, 2, 1); the last < 8
    values are added one by one.
    """
    n = x.shape[-1]
    if n < 16:
        return _left_fold(x)
    nmain = n // 16 * 16
    a, b = x[..., 0:8], x[..., 8:16]
    for s in range(16, nmain, 16):
        a = a + x[..., s : s + 8]
        b = b + x[..., s + 8 : s + 16]
    v = a + b
    pos = nmain
    if n - nmain >= 8:
        v = v + x[..., nmain : nmain + 8]
        pos = nmain + 8
    acc = _halve(v)
    for i in range(pos, n):
        acc = acc + x[..., i]
    return acc


def fold_plan(n: int) -> list[tuple[int, int]]:
    """Window levels of XLA's tree reduce of ``n`` values: ``(n_in, lo_pad)``
    per level, each folding ``n_in`` values in windows of 32 with ``lo_pad``
    zeros in front; the last level's ≤ 32 window sums are reduced whole."""
    levels = []
    while n > FOLD_WINDOW:
        nw = -(-n // FOLD_WINDOW)
        levels.append((n, (nw * FOLD_WINDOW - n) // 2))
        n = nw
    return levels


def block_fold(x: torch.Tensor, vectorized: bool) -> torch.Tensor:
    """XLA's CPU reduce of the last axis (see the module docstring).

    ``vectorized`` says whether the first level is fused with the one-hot
    row producer; later levels are stand-alone reduces (left folds).
    """
    for n, lo in fold_plan(x.shape[-1]):
        nw = -(-n // FOLD_WINDOW)
        xp = torch.zeros(x.shape[:-1] + (nw * FOLD_WINDOW,), dtype=x.dtype, device=x.device)
        xp[..., lo : lo + n] = x
        x = _left_fold(xp.reshape(x.shape[:-1] + (nw, FOLD_WINDOW)))
        vectorized = False
    return _vector_fold(x) if vectorized else _left_fold(x)


def _dense_vector_fold(x: torch.Tensor) -> torch.Tensor:
    """XLA's vectorized reduce of 16..32 gathered rows (the dense z fold).

    16..19 and 24..31 values fold as :func:`_vector_fold`.  20..23 values
    halve the two 8-lane accumulators of the first 16, seed lane 0 of a
    4-lane epilogue with that sum, add the next four, halve again and add
    the rest one by one.  32 values chain their four 8-value chunks into one
    accumulator, then halve.
    """
    n = x.shape[-1]
    if n == 32:
        v = x[..., 0:8] + x[..., 8:16]
        v = v + x[..., 16:24]
        return _halve(v + x[..., 24:32])
    if 20 <= n < 24:
        v = x[..., 16:20].clone()
        v[..., 0] = _halve(x[..., 0:8] + x[..., 8:16]) + v[..., 0]
        acc = _halve(v)
        for i in range(20, n):
            acc = acc + x[..., i]
        return acc
    return _vector_fold(x)


def dense_fold(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU reduce over users of gathered dense rows, on the last axis
    (see the module docstring)."""
    if 16 <= x.shape[-1] <= FOLD_WINDOW:
        return _dense_vector_fold(x)
    return block_fold(x, vectorized=False)


def dense_costs(bundles: torch.Tensor, prices: torch.Tensor) -> torch.Tensor:
    """``Σ_r bundles[..., r]·prices[r]`` over the last axis, in the pinned
    dense cost fold: a left FMA fold from 0 below R = 60, else 32 strided
    FMA lanes halved (see the module docstring)."""
    b, p = bundles.float(), prices.float()
    r = b.shape[-1]
    if r < DENSE_LANE_FOLD_MIN_R:
        acc = torch.zeros(b.shape[:-1], dtype=torch.float32, device=b.device)
        for i in range(r):
            acc = fma(b[..., i], p[i], acc)
        return acc
    lanes = torch.zeros(b.shape[:-1] + (LANES,), dtype=torch.float32, device=b.device)
    for c in range(0, r, LANES):
        w = min(LANES, r - c)
        lanes[..., :w] = fma(b[..., c : c + w], p[c : c + w], lanes[..., :w])
    return _halve(lanes)


def selected_rows(bundles: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """(U, R) rows of the chosen bundles; zero rows for users that are out."""
    pick = chosen.long().clamp(min=0)[:, None, None].expand(-1, 1, bundles.shape[-1])
    rows = bundles.gather(1, pick)[:, 0, :].float()
    return torch.where((chosen >= 0)[:, None], rows, 0.0)


def dense_to_sparse(bundles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (idx, val) (U, B, R) of dense bundles, K = R: each bundle's
    nonzeros first in ascending pool order, then (0, 0.0) slots (the
    reference's ``kernels.ops._dense_to_sparse``)."""
    r = bundles.shape[-1]
    iota = torch.arange(r, device=bundles.device).expand_as(bundles)
    order = torch.argsort(torch.where(bundles != 0, iota, iota + r), dim=-1)
    val = bundles.gather(-1, order).float()
    live = val != 0
    return torch.where(live, order, 0).to(torch.int32), torch.where(live, val, 0.0)


# ---------------------------------------------------------------------------
# selection: one bidder-proxy evaluation per user
# ---------------------------------------------------------------------------


def _first_extremum(scores: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """Index of the first entry equal to ``best`` along axis 1."""
    return (scores == best[:, None]).to(torch.int32).argmax(dim=1)


def select_padded(
    idx: torch.Tensor,
    val: torch.Tensor,
    mask: torch.Tensor,
    pi: torch.Tensor,
    prices: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-user bundle choice on the K-padded book (the reference's
    ``_sparse_selection``).

    Returns ``(sel_idx (U, K), sel_val (U, K) zeroed for inactive users,
    chosen (U,) int32 with −1 = out, active (U,))``.  Scalar π takes the first
    cheapest valid bundle and stays in while it is affordable; vector π takes
    the first highest-surplus valid bundle and stays in while surplus ≥ 0.
    Users with no valid bundle are out.
    """
    prices = prices.float()
    val = val.float()
    gathered = prices[idx.long()]  # (U, B, K)
    costs = cost_fold(val, gathered)  # (U, B)
    if pi.ndim == 1:
        costs = torch.where(mask, costs, float("inf"))
        best = costs.min(dim=1).values
        bhat = _first_extremum(costs, best)
        active = best <= pi
    else:
        if val.shape[-1] == 1:
            raw = fma(-val[..., 0], gathered[..., 0], pi)  # contracted π − v·p
        else:
            raw = pi - costs
        surplus = torch.where(mask, raw, float("-inf"))
        best = surplus.max(dim=1).values
        bhat = _first_extremum(surplus, best)
        active = best >= 0.0
    pick = bhat.long()[:, None, None].expand(-1, 1, idx.shape[-1])
    sel_idx = idx.gather(1, pick)[:, 0, :]
    sel_val = val.gather(1, pick)[:, 0, :] * active[:, None].float()
    chosen = torch.where(active, bhat, -1).to(torch.int32)
    return sel_idx, sel_val, chosen, active


def user_rows(sel_idx: torch.Tensor, sel_val: torch.Tensor, num_resources: int) -> torch.Tensor:
    """(U, R) demand rows of the selected bundles, terms added in k order
    (the reference's ``_user_rows``).

    One-hot compare-and-add passes for R ≤ 128, one row scatter per k above
    it: a pass touches each (u, r) cell at most once, so both give every cell
    ``(0 + w₀) + w₁ + …`` over its matching terms — the reference's values.
    """
    num_users, k = sel_idx.shape
    if num_resources <= ONEHOT_ROWS_MAX_R:
        r_iota = torch.arange(num_resources, dtype=sel_idx.dtype, device=sel_idx.device)
        x = torch.zeros((num_users, num_resources), dtype=torch.float32, device=sel_idx.device)
        for kk in range(k):
            hit = r_iota[None, :] == sel_idx[:, kk, None]
            x = x + torch.where(hit, sel_val[:, kk, None].float(), 0.0)
        return x
    x = torch.zeros((num_users, num_resources), dtype=torch.float32, device=sel_idx.device)
    rows = torch.arange(num_users, device=sel_idx.device)
    for kk in range(k):
        x[rows, sel_idx[:, kk].long()] += sel_val[:, kk].float()
    return x


def block_partials(
    sel_idx: torch.Tensor, sel_val: torch.Tensor, num_resources: int, num_blocks: int
) -> torch.Tensor:
    """(num_blocks, R) partial demand over contiguous user blocks.

    Users are zero-padded to a multiple of ``num_blocks``; block j holds rows
    ``[j·m, (j+1)·m)`` and each (block, pool) column is reduced with XLA's
    fold (:func:`block_fold`) — bit-identical to the reference's
    ``_user_block_partials``.  With one row a block the partials are the
    rows themselves.
    """
    x = user_rows(sel_idx, sel_val, num_resources)
    pad = -x.shape[0] % num_blocks
    if x.shape[0] + pad == num_blocks and num_resources <= ONEHOT_ROWS_MAX_R:
        # One row a block: XLA's reduce is the row itself, computed unfused,
        # where the one-hot sum drops its leading 0 +; a row whose terms are
        # all -0.0 on one pool keeps -0.0 there.
        neg = ((sel_idx == sel_idx[:, :1]) & (sel_val.view(torch.int32) == -(2**31))).all(1)
        x[neg, sel_idx[neg, 0].long()] = -0.0
    if pad:
        x = torch.cat([x, x.new_zeros((pad, num_resources))])
    if x.shape[0] == num_blocks:
        return x
    cols = x.reshape(num_blocks, -1, num_resources).transpose(1, 2)  # (nb, R, m)
    return block_fold(cols, vectorized=not pad and num_resources <= ONEHOT_ROWS_MAX_R)


def chain_sum(partials: torch.Tensor) -> torch.Tensor:
    """Left fold ``((p₀ + p₁) + p₂) + …`` over the leading axis (the
    reference's ``_chain_sum``, shared by every settlement path)."""
    z = partials[0]
    for i in range(1, partials.shape[0]):
        z = z + partials[i]
    return z


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------


def bid_eval(
    bundles: torch.Tensor,  # (U, B, R) float32
    mask: torch.Tensor,  # (U, B) bool
    pi: torch.Tensor,  # (U,) float32, scalar π only
    prices: torch.Tensor,  # (R,) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """One dense clock round → ``(z (R,), chosen (U,) int32, −1 = out)``.

    A masked bundle costs +inf; each user takes its first cheapest bundle
    and stays in while ``cost ≤ π`` (so a user with no valid bundle is in
    only at π = +inf, as in the reference); z folds the chosen rows over
    users with :func:`dense_fold`.
    """
    costs = torch.where(mask, dense_costs(bundles, prices), float("inf"))
    best = costs.min(dim=1).values
    bhat = _first_extremum(costs, best)
    chosen = torch.where(best <= pi, bhat, -1).to(torch.int32)
    return dense_fold(selected_rows(bundles, chosen).T), chosen



def sparse_bid_eval(
    idx: torch.Tensor,  # (U, B, K) int32
    val: torch.Tensor,  # (U, B, K) float32
    mask: torch.Tensor,  # (U, B) bool
    pi: torch.Tensor,  # (U,) or (U, B) float32
    prices: torch.Tensor,  # (R,) float32
    num_resources: int,
    num_blocks: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One clock round over the K-padded book → ``(z, chosen)``.

    ``num_blocks=None`` returns z (R,), the selected bundles scattered into
    one vector; an int returns the (num_blocks, R) block partials of
    :func:`block_partials` instead (the deterministic settlement mode).
    """
    sel_idx, sel_val, chosen, _ = select_padded(idx, val, mask, pi, prices)
    if num_blocks is not None:
        return block_partials(sel_idx, sel_val, num_resources, num_blocks), chosen
    z = torch.zeros(num_resources, dtype=torch.float32, device=idx.device)
    z.index_add_(0, sel_idx.reshape(-1).long(), sel_val.reshape(-1))
    return z, chosen


def csr_costs(
    idx: torch.Tensor, val: torch.Tensor, offsets: torch.Tensor, prices: torch.Tensor,
    num_users: int, num_bundles: int, k_bound: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(costs (U, B), starts, counts) over flat CSR streams.

    Pass k folds element k of every bundle that has one into its cost with
    the same ``v₀p₀``-then-FMA order as :func:`cost_fold`; an empty bundle
    costs exactly 0.0.
    """
    starts = offsets[:-1].long().reshape(num_users, num_bundles)
    counts = (offsets[1:] - offsets[:-1]).long().reshape(num_users, num_bundles)
    costs = torch.zeros((num_users, num_bundles), dtype=torch.float32, device=idx.device)
    nnz = idx.shape[0]
    if nnz == 0:
        return costs, starts, counts
    prices = prices.float()
    for k in range(k_bound):
        live = counts > k
        pos = torch.where(live, starts + k, 0).clamp(max=nnz - 1)
        v = val[pos].float()
        p = prices[idx[pos].long()]
        term = v * p if k == 0 else fma(v, p, costs)
        costs = torch.where(live, term, costs)
    return costs, starts, counts


def sparse_bid_eval_csr(
    idx: torch.Tensor,  # (nnz,) int32
    val: torch.Tensor,  # (nnz,) float32
    offsets: torch.Tensor,  # (U·B + 1,) int32
    mask: torch.Tensor,  # (U, B) bool
    pi: torch.Tensor,  # (U,) or (U, B) float32
    prices: torch.Tensor,  # (R,) float32
    num_resources: int,
    k_bound: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One clock round over flat CSR streams → ``(z (R,), chosen (U,))``.

    Bundle (u, b) owns ``offsets[u·B+b] : offsets[u·B+b+1]``; ``k_bound`` is
    the longest bundle.  Selection follows :func:`select_padded`, and the
    chosen bundle's elements are scattered into z.
    """
    num_users, num_bundles = mask.shape
    costs, starts, counts = csr_costs(
        idx, val, offsets, prices, num_users, num_bundles, k_bound
    )
    if pi.ndim == 1:
        costs = torch.where(mask, costs, float("inf"))
        best = costs.min(dim=1).values
        bhat = _first_extremum(costs, best)
        active = best <= pi
    else:
        surplus = torch.where(mask, pi - costs, float("-inf"))
        best = surplus.max(dim=1).values
        bhat = _first_extremum(surplus, best)
        active = best >= 0.0
    chosen = torch.where(active, bhat, -1).to(torch.int32)
    z = torch.zeros(num_resources, dtype=torch.float32, device=idx.device)
    nnz = idx.shape[0]
    if nnz == 0:
        return z, chosen
    b = bhat.long()[:, None]
    sel_start = starts.gather(1, b)[:, 0]
    sel_count = torch.where(active, counts.gather(1, b)[:, 0], 0)
    for k in range(k_bound):
        live = sel_count > k
        pos = torch.where(live, sel_start + k, 0).clamp(max=nnz - 1)
        z.index_add_(0, idx[pos].long(), torch.where(live, val[pos].float(), 0.0))
    return z, chosen


# ---------------------------------------------------------------------------
# wkv6: the RWKV-6 linear recurrence with data-dependent decay.  No bitwise
# contract: the kernel and the reference's jnp versions are held to float
# tolerance.  Both functions take (T, H, ·) inputs, as the reference's do, or
# a leading batch, (B, T, H, ·), as the port's time mix calls them.
# ---------------------------------------------------------------------------


def _wkv6_batched(r, k, v, w, state):
    """Inputs with a batch axis, and whether the caller gave none."""
    if r.ndim == 3:
        return r[None], k[None], v[None], w[None], None if state is None else state[None], True
    return r, k, v, w, state, False


def wkv6(r, k, v, w, u, state=None):
    """Sequential WKV-6 oracle, in float32::

        S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
        o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

    r, k, w ``(B, T, H, K)``, v ``(B, T, H, V)`` (B optional), u ``(H, K)``,
    state ``(B, H, K, V)`` or None for zeros → (o ``(B, T, H, V)``, final
    state ``(B, H, K, V)``).
    """
    r, k, v, w, state, unbatched = _wkv6_batched(r, k, v, w, state)
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    rf, kf, vf, wf, uf = (x.float() for x in (r, k, v, w, u))
    s = (torch.zeros((b, h, kd, vd), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    outs = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, i], s + uf[:, :, None] * kv))
        s = wf[:, i, :, :, None] * s + kv
    o = torch.stack(outs, dim=1)
    return (o[0], s[0]) if unbatched else (o, s)


def wkv6_chunked(r, k, v, w, u, state=None, chunk: int = 32):
    """Chunked WKV-6 in float32, the log-space algebra of the reference's
    ``wkv6_chunked`` and of the Pallas kernel.  Within a chunk of L tokens,
    with cs the inclusive cumsum of log w and cs_ex = cs − log w::

        o_t    = (r_t ⊙ e^{cs_ex[t]}) · S
                 + Σ_{s<t} [Σ_k r_t[k] k_s[k] e^{cs_ex[t,k] − cs[s,k]}] v_s
                 + (r_t ⊙ u · k_t) v_t
        S_next = diag(e^{cs[L-1]}) S + (k ⊙ e^{cs[L-1] − cs})ᵀ v

    The ragged last chunk is padded with w = 1 and r = k = v = 0.  Shapes as
    :func:`wkv6`.
    """
    r, k, v, w, state, unbatched = _wkv6_batched(r, k, v, w, state)
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    L = min(chunk, t)
    tp = -(-t // L) * L
    dev = r.device

    def chunks(x, fill):
        x = x.float()
        if tp > t:
            x = torch.cat([x, x.new_full((b, tp - t) + x.shape[2:], fill)], dim=1)
        return x.reshape(b, tp // L, L, h, x.shape[-1])

    rf, kf, vf, wf = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0), chunks(w, 1.0)
    uf = u.float()
    s = (torch.zeros((b, h, kd, vd), dtype=torch.float32, device=dev)
         if state is None else state.float())
    tri = torch.tril(torch.ones((L, L), dtype=torch.float32, device=dev), diagonal=-1)
    eye = torch.eye(L, dtype=torch.float32, device=dev)
    outs = []
    for c in range(tp // L):
        rc, kc, vc, wc = rf[:, c], kf[:, c], vf[:, c], wf[:, c]  # (B, L, H, ·)
        lw = torch.log(torch.clamp(wc, min=1e-38))
        cs = torch.cumsum(lw, dim=1)
        cs_ex = cs - lw
        o_state = torch.einsum("blhk,bhkv->blhv", rc * torch.exp(cs_ex), s)
        dif = torch.clamp(cs_ex[:, :, None] - cs[:, None, :], max=0.0)  # (B, L, L, H, K)
        dec = torch.exp(dif) * tri[:, :, None, None]
        scores = torch.einsum("blhk,bmhk,blmhk->bhlm", rc, kc, dec)
        diag = torch.einsum("blhk,hk,blhk->bhl", rc, uf, kc)
        scores = scores + eye * diag[..., None]
        o_intra = torch.einsum("bhlm,bmhv->blhv", scores, vc)
        total = cs[:, -1]  # (B, H, K)
        k_dec = kc * torch.exp(total[:, None] - cs)
        s = torch.exp(total)[..., None] * s + torch.einsum("blhk,blhv->bhkv", k_dec, vc)
        outs.append(o_state + o_intra)
    o = torch.cat(outs, dim=1)[:, :t]
    return (o[0], s[0]) if unbatched else (o, s)
