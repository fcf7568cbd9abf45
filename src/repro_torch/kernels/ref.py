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
"""
from __future__ import annotations

import torch

# Below this pool count the reference builds per-user demand rows with
# one-hot compare-and-add passes that XLA fuses into the block reduce (and
# vectorizes); above it rows come from a scatter and the reduce stands alone.
ONEHOT_ROWS_MAX_R = 128
# XLA's tree-reduction window on the CPU backend
FOLD_WINDOW = 32


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
    v = v[..., 0:4] + v[..., 4:8]
    v = v[..., 0:2] + v[..., 2:4]
    acc = v[..., 0] + v[..., 1]
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
    ``_user_block_partials``.
    """
    x = user_rows(sel_idx, sel_val, num_resources)
    pad = -x.shape[0] % num_blocks
    if pad:
        x = torch.cat([x, x.new_zeros((pad, num_resources))])
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
# the two kernels' plain versions
# ---------------------------------------------------------------------------


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
