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
round; on the card those rounds replay as one CUDA graph (:class:`ClockLoop`,
:func:`_run_clock`).  Demand evaluation is the only thing that differs between
settlement paths: the plain folds here, or the kernels in
:mod:`repro_torch.kernels.ops`.  :func:`sharded_clock_auction` runs the same
clock with the bidders split over a ``torch.distributed`` process group.

Dense problems (``AuctionProblem``, the paper's §III encoding) evaluate
demand in O(U·B·R) through ``bid_eval`` and settle to an ``AuctionResult``;
sparse and CSR problems settle to a ``SparseAuctionResult``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import ops, ref
from .types import (
    AuctionProblem,
    AuctionResult,
    CSRAuctionProblem,
    CSRDemandAux,
    SparseAuctionProblem,
    SparseAuctionResult,
    csr_demand_aux,
    csr_padded_views,
    pad_users,
    padded_from_csr,
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


def sparse_proxy_demand_exact(idx, val, mask, pi, prices, num_resources: int):
    """Bit-compatible twin of :func:`sparse_proxy_demand`: the selected
    bundles become (U, R) demand rows (:func:`ref.user_rows`, the reference's
    ``_user_rows``), column-summed as the reference sums them.

    That column sum is XLA's reduce of one block of U rows, fused with the
    row producer: the fold of :func:`ref.block_partials` with one block.
    """
    sel_idx, sel_val, chosen, active = ref.select_padded(idx, val, mask, pi, prices)
    return ref.block_partials(sel_idx, sel_val, num_resources, 1)[0], chosen, active


sparse_proxy_demand_exact.sparse_signature = True  # type: ignore[attr-defined]
sparse_proxy_demand_exact.exact_settlement = True  # type: ignore[attr-defined]


def _blocked_demand_parts(idx, val, mask, pi, prices, num_resources: int, num_blocks: int):
    """(block partials (num_blocks, R), chosen, active): what a rank of the
    sharded clock computes on its own blocks."""
    sel_idx, sel_val, chosen, active = ref.select_padded(idx, val, mask, pi, prices)
    partials = ref.block_partials(sel_idx, sel_val, num_resources, num_blocks)
    return partials, chosen, active


def sparse_proxy_demand_blocked(idx, val, mask, pi, prices, num_resources: int,
                                num_blocks: int = 8):
    """Settlement-grade demand: z is the fixed left fold of ``num_blocks``
    contiguous user-block partials, each folded in the reference's order —
    bit-identical to ``repro.core.auction.sparse_proxy_demand_blocked``."""
    partials, chosen, active = _blocked_demand_parts(
        idx, val, mask, pi, prices, num_resources, num_blocks
    )
    return ref.chain_sum(partials), chosen, active


sparse_proxy_demand_blocked.sparse_signature = True  # type: ignore[attr-defined]
sparse_proxy_demand_blocked.exact_settlement = True  # type: ignore[attr-defined]
sparse_proxy_demand_blocked.partials_fn = _blocked_demand_parts  # type: ignore[attr-defined]
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
    fn.partials_fn = _blocked_demand_parts  # type: ignore[attr-defined]
    fn.num_blocks = num_blocks  # type: ignore[attr-defined]
    return fn


def csr_proxy_demand(problem: CSRAuctionProblem, prices: torch.Tensor,
                     aux: CSRDemandAux | None = None):
    """O(nnz) demand on the flat CSR streams → (z, chosen, active).

    Without ``aux``, the plain segment form: per-element products, a segment
    sum into bundle costs, and the chosen bundles' elements added into z.
    With ``aux`` (:class:`~repro_torch.core.types.CSRDemandAux`) the costs
    fold as ``k_bound`` prefix-slice adds over the count-sorted k-major
    stream, and z sums pool-major in ``chunk``-wide tiles, only the chunk
    sums added into z.  The costs, and so the selection, are the same bit
    for bit either way (each bundle's terms add in k order); z is
    float-close (it reassociates within a pool)."""
    num_users, num_bundles = problem.bundle_mask.shape
    dev = problem.idx.device
    prices = prices.float()
    costs = torch.zeros(num_users * num_bundles, dtype=torch.float32, device=dev)
    if problem.nnz and aux is None:
        costs.index_add_(0, problem.rows.long(), problem.val * prices[problem.idx.long()])
    elif problem.nnz:
        prod = aux.kmaj_val * prices[aux.kmaj_idx.long()]
        off = 0
        for m in aux.m_k:
            costs[:m] += prod[off:off + m]
            off += m
        costs = costs[aux.inv_count_perm.long()]
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
        if aux is None:
            z.index_add_(0, problem.idx.long(), kept)
        else:
            chunk_sums = torch.where(aux.pool_live, kept[aux.pool_pos.long()], 0.0)
            z.index_add_(0, aux.chunk_pool.long(), chunk_sums.reshape(-1, aux.chunk).sum(1))
    return z, chosen, active


csr_proxy_demand.csr_signature = True  # type: ignore[attr-defined]
csr_proxy_demand.csr_wants_aux = True  # type: ignore[attr-defined]


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


class ClockLoop:
    """Algorithm 1's price loop over static state tensors.

    The loop state — round count ``t``, prices ``p``, previous prices
    ``p_prev``, the done flag and, with ``config.adaptive``, the step
    accelerator, the cap fractions and the last excess signs — lives in
    tensors allocated once; :meth:`reset` loads a start point and
    :meth:`chunk` runs :data:`CHECK_EVERY` rounds in place.  Round for round
    it is the reference's loop body: a round runs only while not done and
    below ``max_rounds``, and a round that finds z ≤ tol keeps its prices,
    so a round issued after the loop has stopped changes nothing.  Because
    a chunk reads and writes only those tensors (and what ``excess`` reads),
    one chunk can be captured as a CUDA graph and replayed.
    """

    def __init__(self, excess, config: ClockConfig, c: torch.Tensor, s: torch.Tensor):
        dev = c.device
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        self.excess, self.config, self.c, self.s = excess, config, c, s
        self.alpha, self.delta = f32(config.alpha), f32(config.delta)
        self.eps, self.tol = f32(config.price_floor_frac), f32(config.tol)
        self.floor = f32(config.step_floor_frac)
        n = c.shape[0]
        self.t = torch.zeros((), dtype=torch.int32, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.p = torch.zeros(n, dtype=torch.float32, device=dev)
        self.p_prev = torch.zeros_like(self.p)
        if config.adaptive:
            self.growth, self.decay = f32(config.alpha_growth), f32(config.delta_decay)
            self.accel_cap = f32(config.accel_cap)
            self.dfloor = f32(config.delta_floor_frac) * self.delta
            self.accel = torch.ones_like(self.p)
            self.dcap = torch.full_like(self.p, float(self.delta))
            self.prev_pos = torch.zeros(n, dtype=torch.bool, device=dev)

    def reset(self, start: torch.Tensor) -> None:
        self.t.zero_()
        self.done.fill_(False)
        self.p.copy_(start)
        self.p_prev.copy_(start)
        if self.config.adaptive:
            self.accel.fill_(1.0)
            self.dcap.fill_(float(self.delta))
            self.prev_pos.fill_(False)

    def running(self) -> bool:
        """Host read: is the loop still going?"""
        return bool(~self.done & (self.t < self.config.max_rounds))

    def chunk(self) -> None:
        alpha, delta, eps, tol, floor = self.alpha, self.delta, self.eps, self.tol, self.floor
        c, s, max_rounds = self.c, self.s, self.config.max_rounds
        adaptive = self.config.adaptive
        t, done, p, p_prev = self.t, self.done, self.p, self.p_prev
        if adaptive:
            accel, dcap, prev_pos = self.accel, self.dcap, self.prev_pos
        for _ in range(CHECK_EVERY):
            run = ~done & (t < max_rounds)
            z = self.excess(p)
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
                accel_n = torch.where(pos & prev_pos, torch.minimum(accel * self.growth,
                                                                    self.accel_cap), 1.0)
                dcap_n = torch.where(prev_pos & ~pos, torch.maximum(dcap * self.decay,
                                                                    self.dfloor), dcap)
                accel = torch.where(run, accel_n, accel)
                dcap = torch.where(run, dcap_n, dcap)
                prev_pos = torch.where(run, pos, prev_pos)
            p = torch.where(run, p_body, p)
            p_prev = torch.where(run, pprev_body, p_prev)
            done = torch.where(run, d, done)
            t = t + run.to(torch.int32)
        self.t.copy_(t)
        self.done.copy_(done)
        self.p.copy_(p)
        self.p_prev.copy_(p_prev)
        if adaptive:
            self.accel.copy_(accel)
            self.dcap.copy_(dcap)
            self.prev_pos.copy_(prev_pos)

    def prices(self) -> torch.Tensor:
        """The loop's prices, then the λ-bisection refiner (eager) on the
        last segment: λ=1 clears, λ=0 is the last infeasible point; it finds
        the smallest clearing λ.  A new tensor, never the loop's own."""
        p, p_prev = self.p, self.p_prev
        if self.config.refine_rounds <= 0:
            return p.clone()
        delta_p = p - p_prev
        lo = torch.zeros((), dtype=torch.float32, device=p.device)
        hi = torch.ones((), dtype=torch.float32, device=p.device)
        for _ in range(self.config.refine_rounds):
            mid = 0.5 * (lo + hi)
            ok = (self.excess(ref.fma(mid.expand_as(delta_p), delta_p, p_prev)) <= self.tol).all()
            lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
        return ref.fma(hi.expand_as(delta_p), delta_p, p_prev)


def _run_clock(
    excess: Callable[[torch.Tensor], torch.Tensor],
    start_prices: torch.Tensor,
    config: ClockConfig,
    c: torch.Tensor,
    s: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1's price loop (plus the λ-bisection refiner) → (rounds, p*).

    Rounds are issued in chunks of :data:`CHECK_EVERY` (:class:`ClockLoop`),
    with one host read of the done flag a chunk.  The first chunk runs
    eagerly.  On the card a clock that outlives it captures one chunk as a
    CUDA graph, kernel launches inside, and replays it until done; on the
    CPU the same chunk runs eagerly, as the caller asked for the CPU.
    """
    loop = ClockLoop(excess, config, c, s)
    loop.reset(start_prices.float())
    loop.chunk()
    if loop.running():
        if start_prices.device.type == "cuda":
            graph = ops.CountedGraph(loop.chunk, warmup=False)
            while loop.running():
                graph.replay()
        else:
            while loop.running():
                loop.chunk()
    return loop.t, loop.prices()


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
    csr_aux: CSRDemandAux | None = None,
) -> AuctionResult | SparseAuctionResult:
    """Run Algorithm 1 to convergence (or ``max_rounds``) and settle.

    The problem's tensors and ``start_prices`` must share one device.  The
    default demand fn is the kernel wrapper's adapter for the encoding
    (:func:`ops.bid_demand_fn` / :func:`ops.csr_bid_demand_fn` /
    :func:`ops.sparse_bid_demand_fn`): the kernel on CUDA tensors, its plain
    version on CPU tensors.  A CSR book with a padded-signature demand fn
    (the settlement family) runs on its exact padded reconstruction, so it
    settles bit-identically to the padded book.  A CSR demand fn that
    wants the scatter-free layouts (``csr_wants_aux``, as
    :func:`csr_proxy_demand`) gets ``csr_aux``, built here by
    :func:`~repro_torch.core.types.csr_demand_aux` when None.
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
        if csr_aux is None and getattr(demand_fn, "csr_wants_aux", False):
            # only fns that read the scatter-free layouts pay the pack-time
            # argsorts (the kernel adapter's z never scatters)
            csr_aux = csr_demand_aux(problem)
        return _clock_auction_csr_native(problem, start_prices, config, demand_fn, csr_aux)
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


def _clock_auction_csr_native(problem, start_prices, config, demand_fn,
                              aux=None) -> SparseAuctionResult:
    if config.break_ties:
        problem = dataclasses.replace(problem, pi=_apply_tie_jitter(problem.pi, config))
    rounds, prices = _run_clock(
        lambda p: demand_fn(problem, p, aux)[0], start_prices, config,
        problem.base_cost, problem.supply_scale,
    )
    z, chosen, active = demand_fn(problem, prices, aux)
    alloc_idx, alloc_val, payments = _csr_settle(problem, prices, chosen, active)
    return SparseAuctionResult(
        prices=prices, alloc_idx=alloc_idx, alloc_val=alloc_val, chosen_bundle=chosen,
        won=active, payments=payments, excess_demand=z, rounds=rounds,
        converged=(z <= config.tol).all(),
    )


# ---------------------------------------------------------------------------
# Multi-device settlement: the clock sharded over users
# ---------------------------------------------------------------------------

# torch 2.13 renamed all_gather_into_tensor (same arguments)
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class UsersMesh:
    """The users axis of a sharded clock: a process group, its size and this
    process's rank in it.  ``group=None`` is one rank with no process group:
    every gather returns its input."""

    group: object
    size: int
    rank: int

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along axis 0, in rank order."""
        if self.group is None:
            return t
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        _all_gather_into(out, t.contiguous(), group=self.group)
        return out


def users_mesh(group=None) -> UsersMesh:
    """The users axis over a ``torch.distributed`` process group (default:
    the WORLD group).  Without an initialised process group it is one rank,
    on this process's device.

    Each process of the group runs the same program on its own device
    (``cuda:<local rank>`` with NCCL, the CPU with gloo); the caller
    initialises the group (``init_process_group``) with its address, world
    size and rank.
    """
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("users_mesh: a process group was given, but torch.distributed "
                             "is not initialised")
        return UsersMesh(None, 1, 0)
    group = dist.group.WORLD if group is None else group
    return UsersMesh(group, dist.get_world_size(group), dist.get_rank(group))


def _sharded_clock_impl(problem: SparseAuctionProblem, start_prices, config: ClockConfig,
                        demand_fn: DemandFn, mesh: UsersMesh, num_blocks: int):
    num_users, num_res = problem.num_users, problem.num_resources
    pi = problem.pi
    if config.break_ties:
        pi = _apply_tie_jitter(pi, config)  # global user index, before the padding

    # Pad users to a multiple of num_blocks (hence of the world size): padded
    # rows never activate and add exact zeros.  This rank holds the
    # contiguous blocks [rank·nb/world, (rank+1)·nb/world).
    padded = pad_users(dataclasses.replace(problem, pi=pi), num_blocks)
    per = padded.num_users // mesh.size
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    idx, val, mask, pi = (t[mine] for t in (padded.idx, padded.val, padded.bundle_mask,
                                            padded.pi))
    partials_fn = getattr(demand_fn, "partials_fn", None)
    local_blocks = num_blocks // mesh.size

    def demand(prices):
        if partials_fn is not None:
            partials, chosen, active = partials_fn(
                idx, val, mask, pi, prices, num_res, local_blocks
            )
        else:
            z_local, chosen, active = demand_fn(idx, val, mask, pi, prices, num_res)
            partials = z_local[None]
        # every rank's block partials in rank order, then the fixed left fold
        # the unsharded blocked proxy runs: the same z on every rank, so every
        # rank runs the same rounds
        return ref.chain_sum(mesh.all_gather(partials)), chosen, active

    rounds, prices = _run_clock(
        lambda p: demand(p)[0], start_prices, config, problem.base_cost, problem.supply_scale
    )
    z, chosen, active = demand(prices)
    alloc_idx, alloc_val, payments = _sparse_settle(
        idx, val, prices, chosen, active, num_res,
        exact=bool(getattr(demand_fn, "exact_settlement", False)),
    )
    users = slice(0, num_users)
    return SparseAuctionResult(
        prices=prices,
        alloc_idx=mesh.all_gather(alloc_idx)[users],
        alloc_val=mesh.all_gather(alloc_val)[users],
        chosen_bundle=mesh.all_gather(chosen)[users],
        won=mesh.all_gather(active.to(torch.uint8))[users].bool(),
        payments=mesh.all_gather(payments)[users],
        excess_demand=z, rounds=rounds, converged=(z <= config.tol).all(),
    )


def sharded_clock_auction(
    problem: SparseAuctionProblem | CSRAuctionProblem,
    start_prices: torch.Tensor,
    config: ClockConfig = ClockConfig(),
    demand_fn: DemandFn | None = None,
    mesh: UsersMesh | None = None,
    num_blocks: int = 8,
) -> SparseAuctionResult:
    """Run Algorithm 1 with the bidders sharded over a process group.

    The book is padded to a multiple of ``num_blocks`` users and split into
    contiguous blocks, ``num_blocks // world`` a rank.  Each round every rank
    evaluates its blocks' partials (the default demand fn's
    ``sparse_bid_eval_partials`` on CUDA tensors, its plain version on CPU
    tensors), all-gathers them into ``(num_blocks, R)`` in rank order and
    folds them with the same fixed left fold as the unsharded blocked proxy
    — so prices, allocations and payments at every world size dividing
    ``num_blocks`` are those of the reference's sharded clock, bit for bit.
    A demand fn with no ``partials_fn`` adds one partial a rank.  Every rank
    returns the whole result, cut back to ``num_users``.

    On the card each chunk of rounds, the collective included, replays as
    one CUDA graph; on the CPU (gloo) the chunks run eagerly.
    ``mesh=None`` takes :func:`users_mesh`.
    """
    if isinstance(problem, CSRAuctionProblem):
        # variable-length CSR rows do not split evenly; shard the exact padded
        # reconstruction instead
        problem = padded_from_csr(problem)
    if not isinstance(problem, SparseAuctionProblem):
        raise TypeError(
            "sharded_clock_auction needs a SparseAuctionProblem — dense "
            "(U, B, R) bundles would shard U·B·R bytes per round; sparsify() "
            "first"
        )
    if mesh is None:
        mesh = users_mesh()
    ndev = mesh.size
    if num_blocks < 1:
        raise ValueError(f"num_blocks={num_blocks} must be >= 1")
    if demand_fn is None:
        demand_fn = ops.blocked_bid_demand_fn(num_blocks)
    if not getattr(demand_fn, "sparse_signature", False):
        raise TypeError(f"demand_fn {demand_fn} is not a sparse demand fn")
    fn_blocks = getattr(demand_fn, "num_blocks", None)
    if fn_blocks is not None and fn_blocks != num_blocks:
        raise ValueError(
            f"demand_fn folds z over {fn_blocks} user blocks but "
            f"num_blocks={num_blocks} was requested — the sharded fold would "
            "silently diverge from the fn's own single-device fold; pass "
            f"num_blocks={fn_blocks} (or demand_fn=blocked_demand_fn("
            f"{num_blocks}))"
        )
    if num_blocks % ndev:
        raise ValueError(
            f"device count {ndev} must divide num_blocks={num_blocks} so each "
            "shard holds whole user blocks (that is what keeps settlement "
            "bit-identical across device counts)"
        )
    return _sharded_clock_impl(problem, start_prices, config, demand_fn, mesh, num_blocks)


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
