"""Ascending clock auction (paper §III, Algorithm 1) in PyTorch.

The auctioneer holds a price clock p ∈ ℝ^R.  Each round every bidder proxy
reports its demand at the current prices (scalar π: the cheapest bundle
while affordable; vector π: the highest-surplus bundle while surplus ≥ 0),
and pools with positive excess demand z tick up by
``min(α·z⁺/s·c, δ·max(p, ε·c))`` (eq. 3, base-cost normalized and capped).

The loop state (round count, prices, previous prices, done flag) stays on
the device.  Rounds after convergence are no-ops, as in the reference's
``while_loop`` body, and the host reads the done flag once every
:data:`CHECK_EVERY` rounds, so a clock on the card is not a round trip per
round.  Demand evaluation is the only thing that differs between
settlement paths: the plain folds here, or the kernels in
:mod:`repro_torch.kernels.ops`.  Multi-device settlement is not ported yet.

Dense problems (``AuctionProblem``, the paper's §III encoding) evaluate
demand in O(U·B·R) through ``bid_eval`` and settle to an ``AuctionResult``;
sparse and CSR problems settle to a ``SparseAuctionResult``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..kernels import ops, ref
from .types import (
    AuctionProblem,
    AuctionResult,
    CSRAuctionProblem,
    SparseAuctionProblem,
    SparseAuctionResult,
    csr_padded_views,
)

# dense demand_fn(bundles, mask, pi, prices)
#     -> (z (R,), chosen (U,), active (U,))   [tagged dense_signature=True]
# sparse demand_fn(idx, val, mask, pi, prices, num_resources)
#     -> (z (R,), chosen (U,), active (U,))   [tagged sparse_signature=True]
# CSR demand_fn(problem, prices, aux=None) -> (z, chosen, active)   [csr_signature]
DemandFn = Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

# rounds between host reads of the clock's done flag
CHECK_EVERY = 8


def bundle_costs(bundles: torch.Tensor, mask: torch.Tensor, prices: torch.Tensor) -> torch.Tensor:
    """(U, B) costs of dense bundles (the pinned dense fold, see
    :func:`ref.dense_costs`), +inf on invalid bundles."""
    return torch.where(mask, ref.dense_costs(bundles, prices), float("inf"))


def proxy_demand(bundles, mask, pi, prices):
    """Paper eq. (1)-(2) bidder proxies on the dense book → ``(x (U, R),
    chosen, active)``: scalar π takes the first cheapest bundle while
    affordable, vector π the first highest-surplus bundle while surplus ≥ 0."""
    costs = bundle_costs(bundles, mask, prices)
    if pi.ndim == 1:
        best = costs.min(dim=1).values
        bhat = ref._first_extremum(costs, best)
        active = best <= pi
    else:
        surplus = torch.where(mask, pi - costs, float("-inf"))
        best = surplus.max(dim=1).values
        bhat = ref._first_extremum(surplus, best)
        active = best >= 0.0
    chosen = torch.where(active, bhat, -1).to(torch.int32)
    return ref.selected_rows(bundles, chosen), chosen, active


def sparse_bundle_costs(
    idx: torch.Tensor, val: torch.Tensor, mask: torch.Tensor, prices: torch.Tensor
) -> torch.Tensor:
    """(U, B) bundle costs (K-term fold, see :func:`ref.cost_fold`), +inf on
    invalid bundles."""
    costs = ref.cost_fold(val.float(), prices.float()[idx.long()])
    return torch.where(mask, costs, float("inf"))


def sparse_proxy_demand(idx, val, mask, pi, prices, num_resources: int):
    """(z, chosen, active) with z scattered straight into (R,) — float-close."""
    sel_idx, sel_val, chosen, active = ref.select_padded(idx, val, mask, pi, prices)
    z = torch.zeros(num_resources, dtype=torch.float32, device=idx.device)
    z.index_add_(0, sel_idx.reshape(-1).long(), sel_val.reshape(-1))
    return z, chosen, active


sparse_proxy_demand.sparse_signature = True  # type: ignore[attr-defined]


def sparse_proxy_demand_blocked(idx, val, mask, pi, prices, num_resources: int,
                                num_blocks: int = 8):
    """Settlement-grade demand: z is the fixed left fold of ``num_blocks``
    contiguous user-block partials, each folded in the reference's order —
    bit-identical to ``repro.core.auction.sparse_proxy_demand_blocked``."""
    sel_idx, sel_val, chosen, active = ref.select_padded(idx, val, mask, pi, prices)
    partials = ref.block_partials(sel_idx, sel_val, num_resources, num_blocks)
    return ref.chain_sum(partials), chosen, active


sparse_proxy_demand_blocked.sparse_signature = True  # type: ignore[attr-defined]
sparse_proxy_demand_blocked.exact_settlement = True  # type: ignore[attr-defined]
sparse_proxy_demand_blocked.num_blocks = 8  # type: ignore[attr-defined]


def blocked_demand_fn(num_blocks: int = 8) -> DemandFn:
    """:func:`sparse_proxy_demand_blocked` with another block count."""
    if num_blocks == 8:
        return sparse_proxy_demand_blocked

    def fn(idx, val, mask, pi, prices, num_resources):
        return sparse_proxy_demand_blocked(
            idx, val, mask, pi, prices, num_resources, num_blocks
        )

    fn.sparse_signature = True  # type: ignore[attr-defined]
    fn.exact_settlement = True  # type: ignore[attr-defined]
    fn.num_blocks = num_blocks  # type: ignore[attr-defined]
    return fn


def csr_proxy_demand(problem: CSRAuctionProblem, prices: torch.Tensor, aux=None):
    """O(nnz) demand on the flat CSR streams, in the plain segment form:
    per-element products, a segment sum into bundle costs, and the chosen
    bundles' elements scattered into z (float-close)."""
    num_users, num_bundles = problem.bundle_mask.shape
    dev = problem.idx.device
    prices = prices.float()
    costs = torch.zeros(num_users * num_bundles, dtype=torch.float32, device=dev)
    if problem.nnz:
        costs.index_add_(0, problem.rows.long(), problem.val * prices[problem.idx.long()])
    costs = torch.where(problem.bundle_mask, costs.reshape(num_users, num_bundles), float("inf"))
    pi = problem.pi
    if pi.ndim == 1:
        best = costs.min(dim=1).values
        bhat = ref._first_extremum(costs, best)
        active = best <= pi
    else:
        surplus = torch.where(problem.bundle_mask, pi - costs, float("-inf"))
        best = surplus.max(dim=1).values
        bhat = ref._first_extremum(surplus, best)
        active = best >= 0.0
    chosen = torch.where(active, bhat, -1).to(torch.int32)
    z = torch.zeros(problem.num_resources, dtype=torch.float32, device=dev)
    if problem.nnz:
        rows = problem.rows.long()
        kept = torch.where(chosen.long()[rows // num_bundles] == rows % num_bundles,
                           problem.val, 0.0)
        z.index_add_(0, problem.idx.long(), kept)
    return z, chosen, active


csr_proxy_demand.csr_signature = True  # type: ignore[attr-defined]


def _csr_settle(problem: CSRAuctionProblem, prices, chosen, active):
    """Award the chosen bundles from the flat streams → padded (U, k_bound)."""
    num_users, num_bundles = problem.bundle_mask.shape
    k = problem.k_bound
    dev = problem.idx.device
    offsets = problem.offsets.long()
    starts = offsets[:-1].reshape(num_users, num_bundles)
    counts = (offsets[1:] - offsets[:-1]).reshape(num_users, num_bundles)
    bsel = chosen.long().clamp(min=0)[:, None]
    start_u = starts.gather(1, bsel)[:, 0]
    count_u = counts.gather(1, bsel)[:, 0]
    kk = torch.arange(k, device=dev)
    live = kk[None, :] < count_u[:, None]
    if problem.nnz == 0:
        alloc_idx = torch.zeros((num_users, k), dtype=torch.int32, device=dev)
        alloc_val = torch.zeros((num_users, k), dtype=torch.float32, device=dev)
    else:
        pos = (start_u[:, None] + kk[None, :]).clamp(0, problem.nnz - 1)
        alloc_idx = torch.where(live, problem.idx[pos], 0).to(torch.int32)
        alloc_val = torch.where(live, problem.val[pos], 0.0)
    alloc_val = alloc_val.float() * active[:, None].float()
    payments = ref.cost_fold(alloc_val, prices[alloc_idx.long()])
    return alloc_idx, alloc_val, payments


@dataclasses.dataclass(frozen=True)
class ClockConfig:
    """Auction hyper-parameters (paper §III.C.2); see the reference for the
    meaning of each knob.  Defaults keep the fixed schedule."""

    alpha: float = 0.08  # price step per unit of normalized excess demand
    delta: float = 0.08  # max fractional price move per round (eq. 3 cap)
    max_rounds: int = 10_000
    tol: float = 0.0  # convergence: z_r ≤ tol ∀r
    price_floor_frac: float = 1e-3  # ε: cap floor so p=0 pools can still move
    step_floor_frac: float = 5e-3  # minimum step (progress guarantee)
    break_ties: bool = False  # perturb π by a user-indexed epsilon
    tie_eps: float = 1e-5
    refine_rounds: int = 0  # λ-bisection rounds after the coarse clock
    alpha_growth: float = 1.0  # adaptive step accelerator (1.0 = off)
    accel_cap: float = 64.0
    delta_decay: float = 1.0  # adaptive cap decay on sign flips (1.0 = off)
    delta_floor_frac: float = 0.05

    @property
    def adaptive(self) -> bool:
        return self.alpha_growth != 1.0 or self.delta_decay != 1.0


def escalate_clock(config: ClockConfig, factor: int = 2) -> ClockConfig:
    """A round-starved clock's escalation: ``factor``× the round budget and
    the adaptive schedule on (kept when it already is)."""
    return dataclasses.replace(
        config,
        max_rounds=config.max_rounds * factor,
        alpha_growth=config.alpha_growth if config.alpha_growth > 1.0 else 1.6,
        delta_decay=config.delta_decay if config.delta_decay < 1.0 else 0.6,
    )


def _apply_tie_jitter(pi: torch.Tensor, config: ClockConfig) -> torch.Tensor:
    """π perturbation for ``break_ties``, indexed by global user position:
    ``π + sign(π)·jitter·|π|`` (one FMA, as XLA contracts it)."""
    n = pi.shape[0]
    u = torch.arange(n, dtype=torch.float32, device=pi.device)
    jitter = torch.tensor(config.tie_eps, dtype=torch.float32) * (1.0 + u / n)
    if pi.ndim == 2:
        jitter = jitter[:, None]
    return ref.fma(torch.sign(pi) * jitter, torch.abs(pi), pi)


def _run_clock(
    excess: Callable[[torch.Tensor], torch.Tensor],
    start_prices: torch.Tensor,
    config: ClockConfig,
    c: torch.Tensor,
    s: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1's price loop (plus the λ-bisection refiner) → (rounds, p*).

    Round for round the reference's loop body: each round runs only while
    not done and below ``max_rounds``, and a round that finds z ≤ tol keeps
    its prices.  Rounds are issued in chunks of :data:`CHECK_EVERY`; a round
    issued after the loop has stopped changes nothing.
    """
    dev = start_prices.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    alpha, delta = f32(config.alpha), f32(config.delta)
    eps, tol, floor = f32(config.price_floor_frac), f32(config.tol), f32(config.step_floor_frac)
    max_rounds = config.max_rounds

    t = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    p = start_prices.float().clone()
    p_prev = p.clone()
    adaptive = config.adaptive
    if adaptive:
        growth, decay = f32(config.alpha_growth), f32(config.delta_decay)
        accel_cap = f32(config.accel_cap)
        dfloor = f32(config.delta_floor_frac) * delta
        accel = torch.ones_like(p)
        dcap = torch.full_like(p, float(delta))
        prev_pos = torch.zeros(p.shape, dtype=torch.bool, device=dev)

    while True:
        for _ in range(CHECK_EVERY):
            run = ~done & (t < max_rounds)
            z = excess(p)
            d = (z <= tol).all()
            pos = z > tol
            rel = torch.maximum(alpha * torch.clamp_min(z, 0.0) / s, floor)
            if adaptive:
                rel = rel * accel
                step = torch.minimum(rel * c, dcap * torch.maximum(p, eps * c))
            else:
                step = torch.minimum(rel * c, delta * torch.maximum(p, eps * c))
            p_next = torch.where(pos, p + step, p)
            p_body = torch.where(d, p, p_next)
            pprev_body = torch.where(d, p_prev, p)
            if adaptive:
                accel_n = torch.where(pos & prev_pos, torch.minimum(accel * growth, accel_cap), 1.0)
                dcap_n = torch.where(prev_pos & ~pos, torch.maximum(dcap * decay, dfloor), dcap)
                accel = torch.where(run, accel_n, accel)
                dcap = torch.where(run, dcap_n, dcap)
                prev_pos = torch.where(run, pos, prev_pos)
            p = torch.where(run, p_body, p)
            p_prev = torch.where(run, pprev_body, p_prev)
            done = torch.where(run, d, done)
            t = t + run.to(torch.int32)
        if not bool(~done & (t < max_rounds)):
            break

    prices = p
    if config.refine_rounds > 0:
        # λ-bisection on the last segment: λ=1 clears, λ=0 is the last
        # infeasible point; find the smallest clearing λ
        delta_p = p - p_prev
        lo, hi = f32(0.0), f32(1.0)
        for _ in range(config.refine_rounds):
            mid = 0.5 * (lo + hi)
            ok = (excess(ref.fma(mid.expand_as(delta_p), delta_p, p_prev)) <= tol).all()
            lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
        prices = ref.fma(hi.expand_as(delta_p), delta_p, p_prev)
    return t, prices


def _sparse_settle(idx, val, prices, chosen, active, num_resources: int, exact: bool):
    """Award the chosen bundles and price them (per user)."""
    bsel = chosen.long().clamp(min=0)[:, None, None].expand(-1, 1, idx.shape[-1])
    alloc_idx = idx.gather(1, bsel)[:, 0, :]
    alloc_val = val.gather(1, bsel)[:, 0, :].float() * active[:, None].float()
    if exact:
        # pay through the chosen bundle's dense row, so duplicate pool
        # indices settle like their dense sum; the row·price fold runs in
        # pool order (payments are float-close to the reference's fold)
        rows = ref.user_rows(alloc_idx, alloc_val, num_resources)
        payments = ref.cost_fold(rows, prices.float().expand_as(rows))
    else:
        payments = ref.cost_fold(alloc_val, prices.float()[alloc_idx.long()])
    return alloc_idx, alloc_val, payments


def clock_auction(
    problem: AuctionProblem | SparseAuctionProblem | CSRAuctionProblem,
    start_prices: torch.Tensor,
    config: ClockConfig = ClockConfig(),
    demand_fn: DemandFn | None = None,
) -> AuctionResult | SparseAuctionResult:
    """Run Algorithm 1 to convergence (or ``max_rounds``) and settle.

    The problem's tensors and ``start_prices`` must share one device.  The
    default demand fn is the kernel wrapper's adapter for the encoding
    (:func:`ops.bid_demand_fn` / :func:`ops.csr_bid_demand_fn` /
    :func:`ops.sparse_bid_demand_fn`): the kernel on CUDA tensors, its plain
    version on CPU tensors.  A CSR book with a padded-signature demand fn
    (the settlement family) runs on its exact padded reconstruction, so it
    settles bit-identically to the padded book.
    """
    if isinstance(problem, AuctionProblem):
        return _clock_auction_dense(problem, start_prices, config,
                                    demand_fn or ops.bid_demand_fn())
    if isinstance(problem, CSRAuctionProblem):
        if demand_fn is None:
            demand_fn = ops.csr_bid_demand_fn()
        if getattr(demand_fn, "sparse_signature", False):
            idx, val = csr_padded_views(problem)
            padded = SparseAuctionProblem(
                idx=idx, val=val, bundle_mask=problem.bundle_mask, pi=problem.pi,
                base_cost=problem.base_cost, supply_scale=problem.supply_scale,
                num_resources=problem.num_resources,
            )
            return _clock_auction_padded(padded, start_prices, config, demand_fn)
        if not getattr(demand_fn, "csr_signature", False):
            raise TypeError(f"demand_fn {demand_fn} does not match the CSR problem encoding")
        return _clock_auction_csr_native(problem, start_prices, config, demand_fn)
    if not isinstance(problem, SparseAuctionProblem):
        raise TypeError(
            f"clock_auction takes AuctionProblem, SparseAuctionProblem or CSRAuctionProblem, "
            f"got {type(problem).__name__}"
        )
    if getattr(demand_fn, "csr_signature", False):
        raise TypeError(f"demand_fn {demand_fn} evaluates CSR problems, got SparseAuctionProblem")
    return _clock_auction_padded(
        problem, start_prices, config, demand_fn or ops.sparse_bid_demand_fn()
    )


def _clock_auction_dense(problem, start_prices, config, demand_fn) -> AuctionResult:
    if not getattr(demand_fn, "dense_signature", False):
        raise TypeError(f"demand_fn {demand_fn} does not match the dense problem encoding")
    bundles, mask, pi = problem.bundles, problem.bundle_mask, problem.pi
    if config.break_ties:
        pi = _apply_tie_jitter(pi, config)
    rounds, prices = _run_clock(
        lambda p: demand_fn(bundles, mask, pi, p)[0], start_prices, config,
        problem.base_cost, problem.supply_scale,
    )
    _, chosen, active = demand_fn(bundles, mask, pi, prices)
    x = ref.selected_rows(bundles, chosen)
    # the reference re-reduces its materialized allocations here: a reduce
    # that stands alone, a left fold even for 16..32 users
    z = ref.block_fold(x.T, vectorized=False)
    return AuctionResult(
        prices=prices, allocations=x, chosen_bundle=chosen, won=active,
        # the row·price fold of the cost pass (payments are float-close to
        # the reference's x @ p)
        payments=ref.dense_costs(x, prices), excess_demand=z, rounds=rounds,
        converged=(z <= config.tol).all(),
    )


def _clock_auction_padded(problem, start_prices, config, demand_fn) -> SparseAuctionResult:
    if not getattr(demand_fn, "sparse_signature", False):
        raise TypeError(f"demand_fn {demand_fn} does not match the sparse problem encoding")
    idx, val, mask, pi = problem.idx, problem.val, problem.bundle_mask, problem.pi
    if config.break_ties:
        pi = _apply_tie_jitter(pi, config)

    def demand(prices):
        return demand_fn(idx, val, mask, pi, prices, problem.num_resources)

    rounds, prices = _run_clock(
        lambda p: demand(p)[0], start_prices, config, problem.base_cost, problem.supply_scale
    )
    z, chosen, active = demand(prices)
    alloc_idx, alloc_val, payments = _sparse_settle(
        idx, val, prices, chosen, active, problem.num_resources,
        exact=bool(getattr(demand_fn, "exact_settlement", False)),
    )
    return SparseAuctionResult(
        prices=prices, alloc_idx=alloc_idx, alloc_val=alloc_val, chosen_bundle=chosen,
        won=active, payments=payments, excess_demand=z, rounds=rounds,
        converged=(z <= config.tol).all(),
    )


def _clock_auction_csr_native(problem, start_prices, config, demand_fn) -> SparseAuctionResult:
    if config.break_ties:
        problem = dataclasses.replace(problem, pi=_apply_tie_jitter(problem.pi, config))
    rounds, prices = _run_clock(
        lambda p: demand_fn(problem, p)[0], start_prices, config,
        problem.base_cost, problem.supply_scale,
    )
    z, chosen, active = demand_fn(problem, prices)
    alloc_idx, alloc_val, payments = _csr_settle(problem, prices, chosen, active)
    return SparseAuctionResult(
        prices=prices, alloc_idx=alloc_idx, alloc_val=alloc_val, chosen_bundle=chosen,
        won=active, payments=payments, excess_demand=z, rounds=rounds,
        converged=(z <= config.tol).all(),
    )


# ---------------------------------------------------------------------------
# SYSTEM feasibility verification (paper §III.B constraints (1)-(6))
# ---------------------------------------------------------------------------


def verify_system(
    problem: AuctionProblem | SparseAuctionProblem | CSRAuctionProblem,
    result: AuctionResult | SparseAuctionResult,
    atol: float = 1e-3,
) -> dict[str, bool]:
    """Check the settled (x, p) against every SYSTEM constraint; returns a
    dict of named booleans (all True = a feasible point of SYSTEM)."""
    mask, pi = problem.bundle_mask, problem.pi
    p, won = result.prices, result.won
    if isinstance(problem, AuctionProblem):
        costs = bundle_costs(problem.bundles, mask, p)
        lost_zero = (result.allocations == 0).all(dim=1)
    else:
        if isinstance(problem, CSRAuctionProblem):
            vidx, vval = csr_padded_views(problem)
        else:
            vidx, vval = problem.idx, problem.val
        costs = sparse_bundle_costs(vidx, vval, mask, p)
        lost_zero = (result.alloc_val == 0).all(dim=1)
    min_cost = costs.min(dim=1).values
    pay = result.payments
    scale = 1.0 + pay.abs()
    chosen = result.chosen_bundle
    if pi.ndim == 2:
        surplus = torch.where(mask, pi - costs, float("-inf"))
        best = surplus.max(dim=1).values
        won_sur = surplus.gather(1, chosen.long().clamp(min=0)[:, None])[:, 0]
        checks = {
            "c1_bundle_integrality": torch.where(won, chosen >= 0, True).all(),
            "c2_no_excess_demand": (result.excess_demand <= atol).all(),
            "c3_winners_afford": torch.where(won, won_sur >= -atol * scale, True).all(),
            "c4_winners_best_bundle": torch.where(won, won_sur >= best - atol * scale, True).all(),
            "c5_losers_below": torch.where(~won, best < atol * scale, True).all(),
            "c6_prices_nonneg": (p >= -atol).all(),
        }
    else:
        checks = {
            "c1_bundle_integrality": torch.where(won, chosen >= 0, lost_zero).all(),
            "c2_no_excess_demand": (result.excess_demand <= atol).all(),
            "c3_winners_afford": torch.where(won, pi >= pay - atol * scale, True).all(),
            "c4_winners_cheapest": torch.where(
                won, (pay - min_cost).abs() <= atol * scale, True
            ).all(),
            "c5_losers_below": torch.where(~won, pi < min_cost + atol * scale, True).all(),
            "c6_prices_nonneg": (p >= -atol).all(),
        }
    flags = torch.stack(list(checks.values())).cpu().tolist()
    return dict(zip(checks, (bool(f) for f in flags)))


def surplus_and_trade(problem, result):
    """Realized total surplus and value of trade (paper §III.B objectives),
    reduced on the host in numpy as the reference does."""
    pi = problem.pi.cpu().numpy()
    chosen = result.chosen_bundle.cpu().numpy()
    if pi.ndim == 2:
        pi = np.take_along_axis(pi, np.maximum(chosen, 0)[:, None], axis=1)[:, 0]
    won = result.won.cpu().numpy()
    pay = result.payments.cpu().numpy()
    surplus = np.sum(np.where(won, pi - pay, 0.0))
    value_of_trade = np.sum(np.where(won & (pay > 0), pay, 0.0))
    return surplus, value_of_trade
