"""Multi-epoch market economy (paper §V), staged settlement on one device.

Counterpart of ``repro.core.economy``: engineering teams hold resources in
clusters, enter buy/sell bids each epoch, and a clock auction with
congestion-weighted reserve prices settles prices and allocations.  The
population is struct-of-arrays (:class:`AgentPopulation`) and the whole bid
book is packed on the host with array ops into the flat CSR encoding, as in
the reference.  The book becomes tensors on the economy's ``device``, the
clock runs there through the settlement demand fn (the partials-mode
``sparse_bid_eval`` kernel on the card), and the settled prices, choices
and payments come back to the host for apply and stats.

Every host step is the reference's numpy, so a port economy and a JAX
economy given the same state settle the same epochs: prices, reserves,
chosen bundles, rounds, migrations, convergence and SYSTEM feasibility bit
for bit, payment-derived stats to float tolerance.

``fused=True`` runs the whole epoch — pack, clock, settle, verify, surplus,
apply — on the device over device-resident state (:mod:`.fused`: CUDA
graphs on the card), and ``pipeline=True`` overlaps one epoch's host stats
with the next epoch's device work in :meth:`Economy.run_horizon`.
``packer="loop"`` packs and applies with the reference's per-agent loops
(the parity oracle of the vectorized packer).  ``export_bid_rows`` and
``drain_bid_deltas`` bridge the economy to the always-on
:class:`~repro_torch.serve.market.MarketService` over stable agent uids.
Settlement runs on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..kernels import ops
from .auction import (
    ClockConfig,
    clock_auction,
    escalate_clock,
    surplus_and_trade,
    verify_system,
)
from .faults import FaultDraw, FaultModel
from .fused import DeviceMarketState, build_fused_epoch
from .policies import BidderPolicy, Observation
from .reserve import (
    DEFAULT_WEIGHTING,
    RELIABILITY_EMA,
    WeightingFn,
    reputation_weighted_reserve,
    reserve_prices,
)
from .types import (
    ResourcePool,
    as_device,
    bundle_cluster_costs,
    csr_problem_from_arrays,
    pack_bids_sparse,
)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a tensor (waits for the device)."""
    return t.cpu().numpy().copy()


@dataclasses.dataclass
class Agent:
    """One engineering team / job in the economy (scalar convenience view).

    The economy itself stores agents as an :class:`AgentPopulation`; this
    dataclass is the ergonomic way to describe one agent at construction
    time and the unit ``AgentPopulation.to_agents`` converts back to.
    """

    name: str
    req: np.ndarray  # (num_rtypes,) per-cluster resource requirement template
    value: float  # private $ value per epoch of having the bundle
    home: int  # current cluster index (-1 = unplaced)
    relocation_cost: float = 0.0  # $ cost to move to another cluster
    mobility: float = 1.0  # fraction of clusters it can run in
    margin0: float = 1.0  # initial bid margin over believed cost (wild bids)
    margin_decay: float = 0.30  # per-epoch multiplicative margin decay
    arbitrage: float = 0.0  # prob. of offering holdings when home is pricey
    budget: float = np.inf

    # mutable state
    placed: int = -1  # cluster currently holding its resources
    epoch: int = 0
    fill_rate: float = 1.0  # EMA of buy-bid fills (policy observation)
    policy: int = 0  # index into the economy's policy list


_POP_FIELDS = (
    "req", "value", "home", "relocation_cost", "mobility",
    "margin0", "margin_decay", "arbitrage", "budget", "placed", "epoch",
    "fill_rate", "policy",
)

# per-epoch EMA weight of the newest fill observation in fill_rate
FILL_EMA = 0.5


@dataclasses.dataclass
class AgentPopulation:
    """Struct-of-arrays agent population — the economy's native encoding.

    All per-agent state lives in parallel arrays over N agents, so bid-book
    construction, belief-cost evaluation, and settlement application are
    pure array programs.  Mutable state (``placed``/``home``/``epoch``) is
    mutated in place by the economy.
    """

    req: np.ndarray  # (N, T) float64 resource requirement templates
    value: np.ndarray  # (N,) float64 private $ value per epoch
    home: np.ndarray  # (N,) int64 home cluster (-1 = none)
    relocation_cost: np.ndarray  # (N,) float64
    mobility: np.ndarray  # (N,) float64 fraction of clusters reachable
    margin0: np.ndarray  # (N,) float64 initial bid margin
    margin_decay: np.ndarray  # (N,) float64 per-epoch margin decay
    arbitrage: np.ndarray  # (N,) float64 P(offer holdings | home congested)
    budget: np.ndarray  # (N,) float64
    placed: np.ndarray  # (N,) int64 cluster holding resources (-1 = none)
    epoch: np.ndarray  # (N,) int64 epochs this agent has bid (drives margin)
    fill_rate: np.ndarray | None = None  # (N,) float64 EMA of buy fills
    policy: np.ndarray | None = None  # (N,) int64 policy-list index
    names: list[str] | None = None  # optional display names

    def __post_init__(self):
        self.req = np.atleast_2d(np.asarray(self.req, np.float64))
        n = self.req.shape[0]
        if self.fill_rate is None:
            self.fill_rate = np.ones(n, np.float64)
        if self.policy is None:
            self.policy = np.zeros(n, np.int64)
        for f in (
            "value",
            "relocation_cost",
            "mobility",
            "margin0",
            "margin_decay",
            "arbitrage",
            "budget",
            "fill_rate",
        ):
            setattr(self, f, np.broadcast_to(np.asarray(getattr(self, f), np.float64), (n,)).copy())
        for f in ("home", "placed", "epoch", "policy"):
            setattr(self, f, np.broadcast_to(
                np.asarray(getattr(self, f), np.int64), (n,)).copy())
        if self.names is not None and len(self.names) != n:
            raise ValueError(f"{len(self.names)} names for {n} agents")

    def __len__(self) -> int:
        return self.req.shape[0]

    @property
    def num_rtypes(self) -> int:
        return self.req.shape[1]

    @classmethod
    def from_agents(cls, agents: Sequence[Agent]) -> "AgentPopulation":
        agents = list(agents)
        if not agents:
            raise ValueError("empty agent list — pass AgentPopulation.empty()")
        return cls(
            req=np.stack([np.asarray(a.req, np.float64) for a in agents]),
            value=np.array([a.value for a in agents], np.float64),
            home=np.array([a.home for a in agents], np.int64),
            relocation_cost=np.array(
                [a.relocation_cost for a in agents], np.float64),
            mobility=np.array([a.mobility for a in agents], np.float64),
            margin0=np.array([a.margin0 for a in agents], np.float64),
            margin_decay=np.array([a.margin_decay for a in agents], np.float64),
            arbitrage=np.array([a.arbitrage for a in agents], np.float64),
            budget=np.array([a.budget for a in agents], np.float64),
            placed=np.array([a.placed for a in agents], np.int64),
            epoch=np.array([a.epoch for a in agents], np.int64),
            fill_rate=np.array([a.fill_rate for a in agents], np.float64),
            policy=np.array([a.policy for a in agents], np.int64),
            names=[a.name for a in agents],
        )

    @classmethod
    def empty(cls, num_rtypes: int) -> "AgentPopulation":
        z = np.zeros((0,))
        return cls(
            req=np.zeros((0, num_rtypes)), value=z, home=z, relocation_cost=z,
            mobility=z, margin0=z, margin_decay=z, arbitrage=z, budget=z,
            placed=z, epoch=z, names=[],
        )

    def to_agents(self) -> list[Agent]:
        """Materialize scalar Agent views (legacy API; O(N) Python)."""
        names = self.names or [f"job-{i}" for i in range(len(self))]
        return [
            Agent(
                name=names[i],
                req=self.req[i].copy(),
                value=float(self.value[i]),
                home=int(self.home[i]),
                relocation_cost=float(self.relocation_cost[i]),
                mobility=float(self.mobility[i]),
                margin0=float(self.margin0[i]),
                margin_decay=float(self.margin_decay[i]),
                arbitrage=float(self.arbitrage[i]),
                budget=float(self.budget[i]),
                placed=int(self.placed[i]),
                epoch=int(self.epoch[i]),
                fill_rate=float(self.fill_rate[i]),
                policy=int(self.policy[i]),
            )
            for i in range(len(self))
        ]

    def margins(self) -> np.ndarray:
        """(N,) current bid margin: margin0 · decay^epoch (vectorized)."""
        return self.margin0 * self.margin_decay ** self.epoch

    def select(self, keep: np.ndarray) -> "AgentPopulation":
        """Sub-population at a boolean mask or index array (copies)."""
        keep = np.asarray(keep)
        idx = np.flatnonzero(keep) if keep.dtype == bool else keep
        names = [self.names[i] for i in idx] if self.names is not None else None
        kw = {f: getattr(self, f)[idx].copy() for f in _POP_FIELDS}
        return AgentPopulation(names=names, **kw)

    def concat(self, other: "AgentPopulation") -> "AgentPopulation":
        """This population followed by ``other`` (copies)."""
        if other.num_rtypes != self.num_rtypes:
            raise ValueError(
                f"cannot concat {other.num_rtypes}-rtype agents onto "
                f"{self.num_rtypes}-rtype population"
            )
        names = None
        if self.names is not None or other.names is not None:
            names = (
                list(self.names or [f"job-{i}" for i in range(len(self))])
                + list(other.names or [f"new-{i}" for i in range(len(other))])
            )
        kw = {
            f: np.concatenate([getattr(self, f), getattr(other, f)])
            for f in _POP_FIELDS
        }
        return AgentPopulation(names=names, **kw)


def _claw_to_capacity_loop(
    placed: np.ndarray,
    req: np.ndarray,
    usage: np.ndarray,
    cap_eff: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-agent reference for :func:`_claw_to_capacity` (parity oracle)."""
    usage = usage.copy()
    evict = np.zeros(placed.shape[0], bool)
    for c in np.flatnonzero((usage > cap_eff + 1e-9).any(axis=1)):
        for a in np.flatnonzero(placed == c)[::-1]:
            if not np.any(usage[c] > cap_eff[c] + 1e-9):
                break
            usage[c] = np.maximum(usage[c] - req[a], 0.0)
            evict[a] = True
        usage[c] = np.minimum(usage[c], cap_eff[c])
    return evict, usage


def _claw_to_capacity(
    placed: np.ndarray,
    req: np.ndarray,
    usage: np.ndarray,
    cap_eff: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Quota clawback: evict holders until usage fits the surviving capacity.

    Pure — returns ``(evict_mask, new_usage)`` without touching inputs.
    Eviction is deterministic LIFO by agent index per over-capacity
    cluster; residual usage not backed by any agent (pre-loaded congestion)
    is clamped away, matching ``CapacityShock``'s "jobs on failed machines
    lose them" semantics.

    The per-agent eviction loop is replaced by one ``subtract.accumulate``
    chain per over-capacity cluster: the clamped sequence
    ``u_k = max(u_{k-1} - r_k, 0)`` equals ``max(d_k, 0)`` where ``d_k`` is
    the unclamped left-to-right subtraction chain (once ``d`` goes
    non-positive it stays there, and the clamp pins ``u`` at 0), so the
    eviction count is the first prefix that fits — bit-identical to the
    sequential per-agent loop.
    """
    usage = usage.copy()
    evict = np.zeros(placed.shape[0], bool)
    for c in np.flatnonzero((usage > cap_eff + 1e-9).any(axis=1)):
        holders = np.flatnonzero(placed == c)[::-1]  # LIFO order
        # d[k] = usage[c] minus the first k holders' bundles, subtracted in
        # exactly the reference's left-to-right order (ufunc accumulate is
        # sequential, so every partial difference matches bit for bit)
        chain = np.concatenate([usage[c][None, :], req[holders]], axis=0)
        d = np.subtract.accumulate(chain, axis=0)  # (len(holders)+1, T)
        fits = ~(np.maximum(d, 0.0) > cap_eff[c] + 1e-9).any(axis=1)
        k = int(np.argmax(fits)) if fits.any() else holders.size
        evict[holders[:k]] = True
        usage[c] = np.minimum(np.maximum(d[k], 0.0), cap_eff[c])
    return evict, usage


@dataclasses.dataclass
class EpochStats:
    epoch: int
    prices: np.ndarray  # (R,) settled unit prices
    reserve: np.ndarray  # (R,) reserve (starting) prices
    psi: np.ndarray  # (R,) pre-auction utilization
    price_ratio: np.ndarray  # (R,) settled / former-fixed-price (paper Fig. 6)
    gamma_median: float  # Table I
    gamma_mean: float  # Table I
    pct_settled: float  # Table I
    buy_util_percentiles: np.ndarray  # Fig. 7: util %ile of settled buys
    sell_util_percentiles: np.ndarray  # Fig. 7: util %ile of settled offers
    migrations: int
    surplus: float
    value_of_trade: float
    rounds: int
    converged: bool
    system_ok: bool
    # True when the clock was seeded with max(p_prev, reserve) instead of the
    # reserve curve (Economy(warm_start=True), second epoch onward)
    warm_started: bool = False
    # -- degraded-mode telemetry (fault-tolerance layer) ---------------------
    # All default to the fault-free values, so fault-free EpochStats are
    # bit-identical to pre-fault-layer behavior.  ``degraded`` is the
    # headline flag: True whenever this epoch's numbers describe anything
    # other than a cleanly converged, fully delivered settlement.
    degraded: bool = False
    clock_escalations: int = 0  # bounded-retry escalations of a starved clock
    rationed_rows: int = 0  # winning buys scaled by the proportional fallback
    dropped_bids: int = 0  # agents whose bid stream dropped this epoch
    seller_failures: int = 0  # winning sellers that failed to deliver
    failed_pools: int = 0  # pools that failed right after settlement
    evictions: int = 0  # agents clawed back (pre-auction loss + post-settle)
    clawback_units: float = 0.0  # resource units reclaimed/lost to faults
    compensation: float = 0.0  # $ refunded to clawed-back agents
    # -- streaming-churn telemetry (population churn since last epoch) -------
    # Conservation accounting for add_agents/remove_agents: arrivals whose
    # placement was rejected for lack of free capacity (they enter the market
    # unplaced instead of having their claimed units silently clamped away),
    # and departure release absorbed by the usage >= 0 floor.  All zero on a
    # churn-free epoch, so pre-existing stats are bit-identical.
    arrivals_rejected: int = 0
    arrival_units_rejected: float = 0.0
    release_shortfall_units: float = 0.0
    # -- ingestion backpressure (MarketService ticks; zero inside Economy) ---
    bids_submitted: int = 0  # deltas accepted into the tick's batch
    bids_withdrawn: int = 0  # withdrawals applied this tick
    bids_rejected: int = 0  # deltas refused by validation
    bids_deferred: int = 0  # deltas refused by the max_pending backpressure cap
    # -- serving health (MarketService deadline-bounded ticks) ---------------
    # A failed tick (non-convergence within the bounded escalation ladder)
    # commits nothing: poll_prices keeps serving the last-good curve while
    # these fields report the degradation.  All default to the healthy
    # values, so Economy epochs and clean service ticks are unchanged.
    deadline_missed: bool = False  # wall-clock deadline cut the ladder short
    tick_failures: int = 0  # consecutive failed ticks (resets on success)
    retry_backoff_s: float = 0.0  # suggested wait before the next retry
    health: str = "healthy"  # ServiceHealth state after this tick


# row kinds in a packed bid book
KIND_OP, KIND_SELL, KIND_BUY = 0, 1, 2


@dataclasses.dataclass
class BidBook:
    """One epoch's packed bid book plus the row metadata settlement needs.

    ``problem`` is the device-ready sparse encoding; the numpy side arrays
    map auction rows back to agents so allocations can be applied without
    re-deriving who bid what.
    """

    problem: object  # CSRAuctionProblem on the economy's device
    pi_mat: np.ndarray  # (U, B) float32, −inf padded (host copy for stats)
    row_kind: np.ndarray  # (U,) int8 ∈ {KIND_OP, KIND_SELL, KIND_BUY}
    row_agent: np.ndarray  # (U,) int64 agent index (−1 for operator rows)
    sell_cluster: np.ndarray  # (U,) int64 offered cluster (−1 elsewhere)
    bundle_cluster: np.ndarray  # (U, B) int64 cluster per buy bundle (−1 pad)

    @property
    def num_rows(self) -> int:
        return self.row_kind.shape[0]


class Economy:
    """Periodic clock-auction economy over clusters × resource types."""

    def __init__(
        self,
        clusters: Sequence[str],
        rtypes: Sequence[str],
        capacity: np.ndarray,  # (num_clusters, num_rtypes)
        base_cost: np.ndarray,  # (num_rtypes,) former fixed $ per unit
        agents: Sequence[Agent] | AgentPopulation,
        weighting: WeightingFn = DEFAULT_WEIGHTING,
        clock: ClockConfig = ClockConfig(),
        seed: int = 0,
        settle_blocks: int = 8,
        packer: str = "vectorized",
        warm_start: bool = False,
        warm_decay: float = 1.0,
        policies: BidderPolicy | Sequence[BidderPolicy] | None = None,
        faults: FaultModel | None = None,
        clock_retries: int = 0,
        ration_fallback: bool = False,
        reliability_discount: float = 1.0,
        fused: bool = False,
        pipeline: bool = False,
        fused_backend: str | None = None,
        fused_slack: bool = False,
        device: str | torch.device = "cuda",
    ):
        if packer not in ("vectorized", "loop"):
            raise ValueError(f"packer must be 'vectorized' or 'loop', got {packer!r}")
        self.packer = packer
        self.device = as_device(device)
        self.clusters = list(clusters)
        self.rtypes = list(rtypes)
        self.capacity = np.asarray(capacity, dtype=np.float64)
        self.base_cost_rt = np.asarray(base_cost, dtype=np.float64)
        if isinstance(agents, AgentPopulation):
            self.pop = agents
        else:
            self.pop = AgentPopulation.from_agents(list(agents))
        self.weighting = weighting
        self.clock = clock
        self.rng = np.random.default_rng(seed)
        # Settlement demand: z is a fixed left fold over settle_blocks
        # contiguous user blocks (the partials-mode kernel on the card, its
        # plain version on the CPU), bit-identical to the reference's
        # blocked proxy.  One device, always: multi-GPU settlement is ROADMAP
        # queue 1, item "Multi-GPU settlement".
        self.settle_blocks = settle_blocks
        self.demand_fn = ops.blocked_bid_demand_fn(settle_blocks)
        # Warm starts: seed each clock with max(p_prev, reserve) instead of
        # the reserve curve (cold, the default, keeps trajectories unchanged).
        self.warm_start = warm_start
        # Staleness decay on the warm seed for pools with no buy fills last
        # epoch; 1.0 keeps full price memory.
        if not 0.0 <= warm_decay <= 1.0:
            raise ValueError(f"warm_decay must be in [0, 1], got {warm_decay}")
        self.warm_decay = warm_decay
        # Bidder policies: None disables them; one policy applies to every
        # agent; a list is indexed by each agent's ``policy`` id.
        if policies is None:
            self.policies: list[BidderPolicy] | None = None
        elif isinstance(policies, BidderPolicy):
            self.policies = [policies]
        else:
            self.policies = list(policies)
        # Fault layer: a seed-deterministic FaultModel injects capacity loss,
        # seller failures and bid dropout as per-epoch overlays; None keeps
        # the fault-free path.  clock_retries bounds the escalate-and-rerun
        # attempts of a round-starved clock; ration_fallback scales winning
        # buys of a still-unconverged epoch to fit; reliability_discount
        # scales how hard pool reliability discounts capacity in the reserve.
        self.faults = faults
        if clock_retries < 0:
            raise ValueError(f"clock_retries must be >= 0, got {clock_retries}")
        self.clock_retries = int(clock_retries)
        self.ration_fallback = bool(ration_fallback)
        self.reliability_discount = float(reliability_discount)
        # sticky-reach storage: last epoch's reach sort keys per agent (NaN
        # rows = no stored keys yet, e.g. arrivals)
        self._reach_keys: np.ndarray | None = None
        self._last_reserve: np.ndarray | None = None  # prior epoch's curve
        self._last_filled: np.ndarray | None = None  # (R,) buy-fill flags
        self.C, self.T = self.capacity.shape
        if self.pop.num_rtypes != self.T:
            raise ValueError(
                f"population has {self.pop.num_rtypes} rtypes, economy has {self.T}"
            )
        self.R = self.C * self.T
        # usage[c, t]: units currently held by placed agents
        self.usage = np.zeros_like(self.capacity)
        held = self.pop.placed >= 0
        np.add.at(self.usage, self.pop.placed[held], self.pop.req[held])
        self.usage = np.minimum(self.usage, self.capacity)
        # every agent's price belief starts at the former fixed prices
        self.belief = np.tile(self.base_cost_rt, self.C)  # (R,)
        self.price_history: list[np.ndarray] = []
        # per-pool delivered-vs-promised capacity EMA (reputation-weighted
        # reserves); all ones unless a fault model is active
        self.pool_reliability = np.ones(self.R, np.float64)
        # effective capacity the last binding epoch settled against
        self._last_cap_eff: np.ndarray | None = None
        # Fused epochs: pack → clock → settle → verify → apply on the device
        # over device-resident market state (see .fused); the staged path
        # stays the parity oracle.  pipeline=True overlaps epoch t's host
        # stats with epoch t+1's device work inside run_horizon.
        if pipeline and not fused:
            raise ValueError("pipeline=True requires fused=True")
        if pipeline and (self.policies is not None or self.faults is not None):
            raise ValueError(
                "pipeline=True requires policies=None and faults=None: both mutate host state "
                "the next epoch's inputs depend on, which would serialize the pipeline anyway"
            )
        if fused and packer != "vectorized":
            raise ValueError(
                "fused=True requires packer='vectorized' (the loop packer is a host-side "
                "oracle; it has no device twin)"
            )
        if fused and clock.break_ties:
            raise ValueError(
                "fused=True does not support clock.break_ties (the tie jitter is indexed by "
                "global row position, which the fused slot layout does not preserve)"
            )
        if fused_slack and not fused:
            raise ValueError("fused_slack=True requires fused=True")
        if fused:
            ops.fused_epoch_z_fn(fused_backend, self.R)  # rejects unknown backends now
        self.fused = bool(fused)
        self.pipeline = bool(pipeline)
        self.fused_backend = fused_backend
        # fused_slack pads the program's agent axis to a power-of-two capacity
        # that only grows (by doubling), so bounded churn keeps one program;
        # dead slots are neutral in allocations but shift the padded folds,
        # so slack epochs are float-close, not bit-exact, to the staged path
        self.fused_slack = bool(fused_slack)
        self._fused_fn = None
        self._fused_n: int | None = None  # agent capacity of the built program
        self._device_state: DeviceMarketState | None = None
        self._device_const: tuple | None = None
        self._state_dirty = True
        # streaming-churn telemetry, reported in the next EpochStats
        self._churn_arrivals_rejected = 0
        self._churn_arrival_units_rejected = 0.0
        self._churn_release_shortfall = 0.0
        # stable agent identities and dirty-bid tracking: uids survive the
        # index compaction of remove_agents; the dirty sets record which
        # agents' sticky bids changed since the last drain_bid_deltas(), so
        # an always-on MarketService book stays in sync in O(Δ) rows
        self._agent_uid = np.arange(len(self.pop), dtype=np.int64)
        self._uid_next = int(len(self.pop))
        self._dirty_uids: set[int] = set()
        self._removed_uids: set[int] = set()

    # -- population bookkeeping ----------------------------------------------
    @property
    def agents(self) -> list[Agent]:
        """Scalar Agent views of the population (read-only convenience —
        mutations to the returned objects do NOT write back)."""
        return self.pop.to_agents()

    def add_agents(self, newcomers: AgentPopulation) -> int:
        """Append arriving agents; placed arrivals claim usage immediately.

        An arrival whose placement does not fit in its cluster's remaining
        free capacity is rejected EXPLICITLY: it joins the market unplaced
        (``placed = -1``) and is counted into the next EpochStats
        (``arrivals_rejected`` / ``arrival_units_rejected``).  The old
        behavior silently clamped usage to capacity, making the claimed
        units vanish and breaking the placed-usage conservation invariant
        the scenario engine enforces.  Returns the number of arrivals whose
        placement was actually accepted (credited into ``usage``).
        """
        placed = np.asarray(newcomers.placed, np.int64).copy()
        held = np.flatnonzero(placed >= 0)
        accepted = 0
        if held.size:
            # fast path: clusters whose total influx fits admit their whole
            # arrival cohort vectorized; over-subscribed clusters fall back
            # to first-fit in arrival order so admission is deterministic
            influx = np.zeros_like(self.usage)
            np.add.at(influx, placed[held], newcomers.req[held])
            fits = ~(self.usage + influx > self.capacity).any(axis=1)
            easy = held[fits[placed[held]]]
            np.add.at(self.usage, placed[easy], newcomers.req[easy])
            accepted += int(easy.size)
            for i in held[~fits[placed[held]]]:
                c = placed[i]
                if np.all(self.usage[c] + newcomers.req[i] <= self.capacity[c]):
                    self.usage[c] += newcomers.req[i]
                    accepted += 1
                else:
                    placed[i] = -1
                    self._churn_arrivals_rejected += 1
                    self._churn_arrival_units_rejected += float(
                        newcomers.req[i].sum()
                    )
        if accepted != held.size:
            newcomers = dataclasses.replace(newcomers, placed=placed)
        self.pop = self.pop.concat(newcomers)
        if self._reach_keys is not None:
            # arrivals have no stored reach yet: NaN rows force a fresh draw
            self._reach_keys = np.vstack(
                [self._reach_keys, np.full((len(newcomers), self.C), np.nan)]
            )
        new_uids = np.arange(self._uid_next, self._uid_next + len(newcomers), dtype=np.int64)
        self._uid_next += len(newcomers)
        self._agent_uid = np.concatenate([self._agent_uid, new_uids])
        self._dirty_uids.update(new_uids.tolist())
        self._state_dirty = True
        return accepted

    def remove_agents(self, mask: np.ndarray) -> int:
        """Remove agents at a boolean mask; placed leavers free their usage.
        Returns how many of the removed agents were placed.

        A release that would drive a pool's usage negative (phantom usage,
        e.g. after an external capacity mutation) is absorbed by the
        usage >= 0 floor as before, but the absorbed amount is now counted
        into the next EpochStats (``release_shortfall_units``) instead of
        vanishing silently."""
        mask = np.asarray(mask, bool)
        gone = self.pop.select(mask)
        held = gone.placed >= 0
        np.add.at(self.usage, gone.placed[held], -gone.req[held])
        shortfall = float(-np.minimum(self.usage, 0.0).sum())
        if shortfall > 0.0:
            self._churn_release_shortfall += shortfall
        self.usage = np.maximum(self.usage, 0.0)
        self.pop = self.pop.select(~mask)
        if self._reach_keys is not None:
            self._reach_keys = self._reach_keys[~mask]
        gone_uids = self._agent_uid[mask]
        self._removed_uids.update(gone_uids.tolist())
        self._dirty_uids.difference_update(gone_uids.tolist())
        self._agent_uid = self._agent_uid[~mask]
        self._state_dirty = True
        return int(held.sum())

    def _consume_churn_counters(self, dry_run: bool) -> tuple[int, float, float]:
        """Churn telemetry accumulated since the last binding epoch.

        Dry runs report without resetting (side-effect free), binding
        epochs consume the counters."""
        vals = (
            self._churn_arrivals_rejected,
            self._churn_arrival_units_rejected,
            self._churn_release_shortfall,
        )
        if not dry_run:
            self._churn_arrivals_rejected = 0
            self._churn_arrival_units_rejected = 0.0
            self._churn_release_shortfall = 0.0
        return vals

    # -- always-on service bridge (serve.market) -------------------------------
    def export_bid_rows(
        self, agents: np.ndarray | None = None
    ) -> tuple[list[str], np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Sticky buy bids for a persistent :class:`MarketBook`, packed.

        Returns ``(keys, idx_rows, val_rows, mask_rows, pi_rows)`` ready for
        ``MarketBook.upsert_rows``: one row per agent, one XOR bundle per
        reachable cluster (home first, then ascending cluster index,
        truncated to the mobility budget), valued at the agent's requirement
        and priced at ``min(value − relocation, belief·(1+margin), budget)``.

        The export is RNG-free (deterministic reach, no arbitrage coin),
        because a streaming service's resting bids persist between auctions:
        re-exporting an unchanged agent yields a bit-identical row.  Keys are
        ``agent-<uid>`` over the stable uids, so rows survive index
        compaction on departures.
        """
        pop = self.pop
        if agents is None:
            agents = np.arange(len(pop))
        agents = np.asarray(agents, np.int64)
        n, C, T = agents.size, self.C, self.T
        home = pop.home[agents]
        n_reach = np.clip(np.rint(pop.mobility[agents] * C).astype(np.int64), 1, C)
        # deterministic reach order: home first, then cluster index
        order_key = np.broadcast_to(np.arange(C, dtype=np.float64), (n, C)).copy()
        has_home = home >= 0
        order_key[np.flatnonzero(has_home), home[has_home]] = -1.0
        order = np.argsort(order_key, axis=1, kind="stable")
        valid = np.arange(C)[None, :] < n_reach[:, None]
        believed = bundle_cluster_costs(pop.req[agents], self.belief)  # (n, C)
        away = np.arange(C)[None, :] != home[:, None]
        ceiling = np.minimum(
            np.minimum(
                pop.value[agents, None] - pop.relocation_cost[agents, None] * away,
                believed * (1.0 + pop.margins()[agents])[:, None],
            ),
            pop.budget[agents, None],
        )
        bc = np.where(valid, order, 0)
        idx_rows = (bc[:, :, None] * T + np.arange(T)[None, None, :]).astype(np.int32)
        idx_rows = np.where(valid[:, :, None], idx_rows, 0)
        val_rows = np.where(valid[:, :, None], pop.req[agents, None, :], 0.0).astype(np.float32)
        pi_rows = np.where(valid, np.take_along_axis(ceiling, bc, axis=1), 0.0).astype(np.float32)
        # a bundle priced at or below zero can never win: mask it out so the
        # book's validation (pi > 0 where mask) holds
        mask_rows = valid & (pi_rows > 0.0)
        pi_rows = np.where(mask_rows, pi_rows, 0.0)
        val_rows = np.where(mask_rows[:, :, None], val_rows, 0.0)
        idx_rows = np.where(mask_rows[:, :, None], idx_rows, 0)
        keys = [f"agent-{u}" for u in self._agent_uid[agents]]
        return keys, idx_rows, val_rows, mask_rows, pi_rows

    def drain_bid_deltas(
        self,
    ) -> tuple[list[str], tuple[list[str], np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Bid-book deltas accumulated since the last drain.

        Returns ``(withdraw_keys, upserts)`` where ``upserts`` has the
        :meth:`export_bid_rows` layout, covering exactly the agents whose
        sticky bids changed (arrivals, policy actions) and the uids that
        departed.  Applying both to a MarketBook previously synced with
        ``export_bid_rows()`` re-synchronizes it in O(Δ)."""
        withdraw = [f"agent-{u}" for u in sorted(self._removed_uids)]
        dirty = np.array(sorted(self._dirty_uids), dtype=np.int64)
        # uids -> current indices: _agent_uid is strictly increasing (concat
        # appends fresh uids; select preserves order), so searchsorted maps
        idx = np.searchsorted(self._agent_uid, dirty)
        upserts = self.export_bid_rows(idx)
        self._removed_uids.clear()
        self._dirty_uids.clear()
        return withdraw, upserts

    # -- pool bookkeeping ----------------------------------------------------
    def pool_idx(self, c: int, t: int) -> int:
        return c * self.T + t

    def pools(self) -> list[ResourcePool]:
        return self._pools_from(self.capacity, self.usage)

    def _pools_from(
        self,
        capacity: np.ndarray,
        usage: np.ndarray,
        reliability: np.ndarray | None = None,
    ) -> list[ResourcePool]:
        """Pool views over explicit (possibly fault-degraded) arrays."""
        psi = np.clip(usage / np.maximum(capacity, 1e-9), 0.0, 1.0)
        rel = np.ones(self.R) if reliability is None else reliability
        out = []
        for c, cname in enumerate(self.clusters):
            for t, tname in enumerate(self.rtypes):
                free = max(capacity[c, t] - usage[c, t], 0.0)
                out.append(
                    ResourcePool(
                        cluster=cname,
                        rtype=tname,
                        base_cost=float(self.base_cost_rt[t]),
                        utilization=float(psi[c, t]),
                        supply=float(free),
                        reliability=float(rel[c * self.T + t]),
                    )
                )
        return out

    def utilization(self) -> np.ndarray:
        return np.clip(self.usage / np.maximum(self.capacity, 1e-9), 0.0, 1.0)

    def util_percentile(self, c: int) -> float:
        """Percentile rank of cluster c's mean utilization across clusters."""
        m = self.utilization().mean(axis=1)
        return 100.0 * (m < m[c] - 1e-12).mean()

    def _util_percentiles(self) -> np.ndarray:
        """(C,) percentile rank of every cluster's mean utilization."""
        m = self.utilization().mean(axis=1)
        return 100.0 * (m[None, :] < m[:, None] - 1e-12).mean(axis=1)

    # -- preliminary prices (paper Fig. 5) ------------------------------------
    def preview_prices(self) -> np.ndarray:
        """Provisional settlement prices for the *current* bid book — the
        market front end shows these during the bid-collection window so
        teams can react before the final, binding run."""
        return self.run_epoch(dry_run=True).prices

    # -- epoch randomness -----------------------------------------------------
    def _draw_bid_randomness(self) -> tuple[np.ndarray, np.ndarray]:
        """One epoch's random draws, as flat arrays.

        ``u_arb`` (N,): the arbitrage coin per agent; ``perm_keys`` (N, C):
        sort keys whose row-wise stable argsort is the agent's cluster-reach
        permutation.  It is the only RNG the epoch touches, so ``dry_run``
        restores exactly this much state, and the reference economy draws
        the identical stream.
        """
        n = len(self.pop)
        u_arb = self.rng.random(n)
        perm_keys = self.rng.random((n, self.C))
        return u_arb, perm_keys

    # -- fault overlays -------------------------------------------------------
    def _epoch_faults(self) -> FaultDraw | None:
        """This epoch's realized faults, or None when the model is off.

        Draws are counter-based on (model seed, epoch index, channel), so
        they consume no mutable state — dry runs and crash-resumed horizons
        see the identical fault sequence for free.
        """
        if self.faults is None or self.faults.disabled:
            return None
        return self.faults.draw(
            len(self.price_history), len(self.pop), self.C, self.T
        )

    def _holding_value(self, agent_idx: np.ndarray, placed: np.ndarray) -> float:
        """$ value of the given agents' held bundles at the last settled
        prices (base cost before any epoch settles) — the compensation paid
        when those holdings are clawed back."""
        if agent_idx.size == 0:
            return 0.0
        prices = (
            self.price_history[-1].astype(np.float64)
            if self.price_history
            else np.tile(self.base_cost_rt, self.C)
        ).reshape(self.C, self.T)
        return float((self.pop.req[agent_idx] * prices[placed[agent_idx]]).sum())

    def _epoch_view(
        self,
    ) -> tuple[
        FaultDraw | None,
        np.ndarray,
        np.ndarray,
        np.ndarray | None,
        np.ndarray | None,
        float,
        float,
    ]:
        """Fault overlays for the epoch about to settle, as pure views.

        Returns ``(draw, cap_eff, usage_eff, placed_override, evict_mask,
        clawback_units, compensation)``.  Nothing is committed here —
        binding epochs commit the pre-auction clawback in
        :meth:`_settle_epoch`, dry runs consume the views and drop them —
        so ``preview_prices`` stays side-effect-free (and settles the same
        bid book the binding run will) with faults active.
        """
        draw = self._epoch_faults()
        cap_eff, usage_eff = self.capacity, self.usage
        placed_override = evict = None
        claw_units, comp = 0.0, 0.0
        if draw is not None and draw.capacity_scale is not None:
            cap_eff = self.capacity * draw.capacity_scale
            if np.any(self.usage > cap_eff + 1e-9):
                evict, usage_eff = _claw_to_capacity(
                    self.pop.placed, self.pop.req, self.usage, cap_eff
                )
                claw_units = float(
                    np.maximum(self.usage - usage_eff, 0.0).sum()
                )
                comp = self._holding_value(np.flatnonzero(evict), self.pop.placed)
                placed_override = self.pop.placed.copy()
                placed_override[evict] = -1
        return draw, cap_eff, usage_eff, placed_override, evict, claw_units, comp

    def _post_settlement_faults(
        self, draw: FaultDraw, cap_eff: np.ndarray, stats: dict
    ) -> dict:
        """Seller flakes and pool failures, realized right after settlement.

        Delivered capacity per pool = ``cap_eff`` minus flaked winning
        sellers' handed-back bundles, times ``pool_fail_scale`` on failed
        pools.  Usage above delivered triggers quota clawback: this epoch's
        winning buyers are evicted LIFO with a full refund of their payment
        as compensation, then any residual phantom usage is clamped (jobs
        already on the failed machines lose them).  Finally each pool's
        reliability EMA absorbs the delivered-vs-nominal observation, which
        is what feeds next epoch's reputation-weighted reserves.
        """
        out = {
            "seller_failures": 0, "failed_pools": 0,
            "evictions": 0, "clawback_units": 0.0, "compensation": 0.0,
        }
        pop = self.pop
        delivered = cap_eff.astype(np.float64).copy()
        if draw.seller_fail_u is not None and len(stats["sell_agents"]):
            sa = stats["sell_agents"]
            flake = draw.seller_fail_u[sa] < self.faults.seller_fail
            if flake.any():
                # the capacity a flaked seller handed back turns out dead
                out["seller_failures"] = int(flake.sum())
                np.subtract.at(
                    delivered, stats["sell_clusters"][flake], pop.req[sa[flake]]
                )
                delivered = np.maximum(delivered, 0.0)
        if draw.pool_fail is not None and draw.pool_fail.any():
            fail = draw.pool_fail.reshape(self.C, self.T)
            out["failed_pools"] = int(draw.pool_fail.sum())
            delivered = np.where(
                fail, delivered * self.faults.pool_fail_scale, delivered
            )
        if np.any(self.usage > delivered + 1e-9):
            ba, bcs = stats["buy_agents"], stats["buy_clusters"]
            scale, pays = stats["buy_scale"], stats["buy_payments"]
            usage = self.usage.copy()
            evict = np.zeros(len(ba), bool)
            for c in np.flatnonzero((usage > delivered + 1e-9).any(axis=1)):
                for j in np.flatnonzero(bcs == c)[::-1]:  # LIFO
                    if not np.any(usage[c] > delivered[c] + 1e-9):
                        break
                    usage[c] = np.maximum(
                        usage[c] - scale[j] * pop.req[ba[j]], 0.0
                    )
                    evict[j] = True
            usage = np.minimum(usage, delivered)
            out["clawback_units"] = float(
                np.maximum(self.usage - usage, 0.0).sum()
            )
            self.usage = usage
            if evict.any():
                out["evictions"] = int(evict.sum())
                out["compensation"] = float(pays[evict].sum())
                pop.placed[ba[evict]] = -1
        # reliability EMA over delivered-vs-nominal (healthy epochs recover
        # the score geometrically, mirroring the per-agent fill_rate EMA)
        obs = np.clip(
            delivered / np.maximum(self.capacity, 1e-9), 0.0, 1.0
        ).reshape(-1)
        self.pool_reliability = (
            1.0 - RELIABILITY_EMA
        ) * self.pool_reliability + RELIABILITY_EMA * obs
        return out

    # -- bidder policies ------------------------------------------------------
    def observation(self) -> Observation:
        """The policy observation for the epoch about to be settled (copies —
        policies may scribble on it without touching economy state)."""
        return Observation(
            epoch=len(self.price_history),
            prices=(
                self.price_history[-1].copy() if self.price_history else None
            ),
            reserve=(
                None if self._last_reserve is None
                else self._last_reserve.copy()
            ),
            psi=self.utilization().reshape(-1).copy(),
            belief=self.belief.copy(),
            fill_rate=self.pop.fill_rate.copy(),
            num_clusters=self.C,
            num_rtypes=self.T,
        )

    def _apply_policies(
        self, perm_keys: np.ndarray, dry_run: bool
    ) -> tuple[
        np.ndarray, np.ndarray | None, np.ndarray | None, np.ndarray | None
    ]:
        """Fold every policy's action into this epoch's packer inputs.

        Returns ``(perm_keys, pi_scale, arbitrage, margin)`` — the effective
        reach sort keys (sticky keys restored, bias added) plus the optional
        π scale, sell-intent, and margin override arrays, all full-N.
        Binding epochs
        also store this epoch's (pre-bias) reach keys for next epoch's
        sticky-reach choices; dry runs store nothing, so ``preview_prices``
        stays side-effect-free with policies attached.
        """
        if not self.policies:
            return perm_keys, None, None, None
        pop = self.pop
        if len(pop) and int(pop.policy.max()) >= len(self.policies):
            raise ValueError(
                f"agent policy id {int(pop.policy.max())} out of range for "
                f"{len(self.policies)} configured policies"
            )
        obs = self.observation()
        # perm_keys is this epoch's fresh draw, owned by the caller and not
        # reused — mutate it in place (policy subsets are disjoint, so no
        # cross-policy aliasing) and keep one copy as the pre-bias store
        base_keys = perm_keys.copy()  # post-sticky, pre-bias: next epoch's store
        pi_scale: np.ndarray | None = None
        arb: np.ndarray | None = None
        margin: np.ndarray | None = None
        acted: list[np.ndarray] = []
        for pid, pol in enumerate(self.policies):
            idx = np.flatnonzero(pop.policy == pid)
            if idx.size == 0:
                continue
            act = pol.act(obs, pop, idx)
            if act is None:
                continue
            acted.append(idx)
            if act.redraw_reach is not None and self._reach_keys is not None:
                keep = ~np.asarray(act.redraw_reach, bool)
                keep &= ~np.isnan(self._reach_keys[idx]).any(axis=1)
                rows = idx[keep]
                perm_keys[rows] = self._reach_keys[rows]
                base_keys[rows] = self._reach_keys[rows]
            if act.reach_bias is not None:
                perm_keys[idx] += act.reach_bias
            if act.pi_scale is not None:
                if pi_scale is None:
                    pi_scale = np.ones(len(pop), np.float64)
                pi_scale[idx] = act.pi_scale
            if act.arbitrage is not None:
                if arb is None:
                    arb = pop.arbitrage.copy()
                arb[idx] = act.arbitrage
            if act.margin is not None:
                if margin is None:
                    margin = pop.margins()
                margin[idx] = act.margin
        if not dry_run:
            self._reach_keys = base_keys
            # policy actions changed these agents' effective bids: mark them
            # dirty so the service bridge re-exports their rows
            for idx in acted:
                self._dirty_uids.update(self._agent_uid[idx].tolist())
        return perm_keys, pi_scale, arb, margin

    # -- bid-book construction -----------------------------------------------
    def _pack_bids_vectorized(
        self,
        psi_flat: np.ndarray,
        tilde_p: np.ndarray,
        base_cost_flat: np.ndarray,
        u_arb: np.ndarray,
        perm_keys: np.ndarray,
        pi_scale: np.ndarray | None = None,
        arbitrage: np.ndarray | None = None,
        margin: np.ndarray | None = None,
        dropout: np.ndarray | None = None,
        placed_override: np.ndarray | None = None,
        free: np.ndarray | None = None,
    ) -> BidBook:
        """Assemble the epoch bid book as pure array ops — O(nnz), no
        per-agent Python — emitting the variable-K CSR encoding directly.

        Row layout: operator lots in pool order, then per agent in index
        order a trader's sell row (if it offers this epoch) immediately
        followed by its buy row.  Buy bundles are ordered home-cluster-first,
        then by the agent's reach permutation, truncated to its reach budget.
        Operator rows hold 1 element, sell and buy bundles T each, unreached
        XOR slots none — byte for byte the reference packer's book.
        """
        pop = self.pop
        n, C, T, R = len(pop), self.C, self.T, self.R
        placed = pop.placed if placed_override is None else placed_override
        home = pop.home
        arb = pop.arbitrage if arbitrage is None else arbitrage

        # (a) who sells, who buys
        psi_home0 = psi_flat[np.clip(placed, 0, C - 1) * T]  # rtype-0 util at placed
        sells = (
            (placed >= 0)
            & (arb > 0)
            & (u_arb < arb)
            & (psi_home0 > 0.75)
        )
        if dropout is not None:
            # bid-stream dropout: the agent submits nothing this epoch — it
            # only masks rows out of the book; the epoch's pre-drawn
            # randomness was consumed identically, so packer parity holds
            sells &= ~dropout
        wants = (placed < 0) | sells
        if dropout is not None:
            wants &= ~dropout

        buyers = np.flatnonzero(wants)
        sellers = np.flatnonzero(sells)
        nb = buyers.size

        # believed costs only for rows that price something: sellers are a
        # subset of buyers (a trader always re-buys), so one (nb, C) matrix
        # serves both the trader and buy paths.
        believed_b = bundle_cluster_costs(pop.req[buyers], self.belief)

        # (b) reach (buyers only): home first, then the reach permutation,
        # truncated to the agent's reach budget
        home_b = home[buyers]
        perm = np.argsort(perm_keys[buyers], axis=1, kind="stable")  # (nb, C)
        pos = np.empty_like(perm)
        np.put_along_axis(
            pos, perm, np.broadcast_to(np.arange(C, dtype=np.int64), (nb, C)), axis=1
        )
        n_reach = np.minimum(
            np.maximum(1, np.rint(pop.mobility[buyers] * C).astype(np.int64)), C
        )
        key = pos.astype(np.float64)
        key[key >= n_reach[:, None]] = np.inf  # outside the reach slice
        has_home = np.flatnonzero(home_b >= 0)
        key[has_home, home_b[has_home]] = -1.0  # home always first, always in
        order = np.argsort(key, axis=1, kind="stable")  # clusters in bundle order
        if free is None:
            free = np.maximum(self.capacity - self.usage, 0.0).reshape(-1)  # (R,)
        op_pools = np.flatnonzero(free > 1e-9)
        n_op = op_pools.size

        B = max(int(n_reach.max()) if nb else 1, 1)
        U = n_op + sellers.size + nb

        # (c) row offsets: ops first, then sell-row/buy-row interleaved per agent
        rows_per_agent = sells.astype(np.int64) + wants.astype(np.int64)
        row0 = n_op + np.concatenate(([0], np.cumsum(rows_per_agent)[:-1]))
        sell_row = row0[sellers]
        buy_row = row0[buyers] + sells[buyers]

        mask = np.zeros((U, B), bool)
        counts = np.zeros((U, B), np.int64)
        pi_mat = np.full((U, B), -np.inf, np.float32)
        row_kind = np.full((U,), KIND_BUY, np.int8)
        row_agent = np.full((U,), -1, np.int64)
        sell_cluster = np.full((U,), -1, np.int64)
        bundle_cluster = np.full((U, B), -1, np.int64)

        t_ar = np.arange(T, dtype=np.int64)
        counts[:n_op, 0] = 1  # operator lots carry one nonzero
        if sellers.size:
            counts[sell_row, 0] = T
        if nb:
            bc = order[:, :B]  # (nb, B) clusters in bundle order
            valid = np.arange(B)[None, :] < n_reach[:, None]
            counts[buy_row] = np.where(valid, T, 0)  # unreached slots: nothing
        offsets = np.zeros(U * B + 1, np.int64)
        offsets[1:] = np.cumsum(counts.reshape(-1))
        starts = offsets[:-1].reshape(U, B)
        nnz = int(offsets[-1])
        flat_idx = np.zeros(nnz, np.int32)
        flat_val = np.zeros(nnz, np.float32)

        # (d) operator sells spare capacity at reserve — one quantity-collapsed
        # row per pool (the seller stay-in rule is scale-invariant).
        flat_idx[starts[:n_op, 0]] = op_pools
        flat_val[starts[:n_op, 0]] = -free[op_pools]
        mask[:n_op, 0] = True
        pi_mat[:n_op, 0] = (
            -free[op_pools] * tilde_p.astype(np.float64)[op_pools]
        ).astype(np.float32)
        row_kind[:n_op] = KIND_OP

        # (e) traders: offer holdings at home at 15% under believed revenue
        if sellers.size:
            # sellers ⊂ buyers and both are sorted, so a searchsorted maps a
            # seller to its believed-cost row
            sell_pos = np.searchsorted(buyers, sellers)
            spos = starts[sell_row, 0][:, None] + t_ar[None, :]
            flat_idx[spos] = placed[sellers, None] * T + t_ar[None, :]
            flat_val[spos] = (-pop.req[sellers]).astype(np.float32)
            mask[sell_row, 0] = True
            exp_rev = believed_b[sell_pos, placed[sellers]]
            pi_mat[sell_row, 0] = (-exp_rev * (1.0 - 0.15)).astype(np.float32)
            row_kind[sell_row] = KIND_SELL
            row_agent[sell_row] = sellers
            sell_cluster[sell_row] = placed[sellers]

        # (f) buyers: one XOR bundle per reachable cluster, π capped at
        # min(value − relocation, believed·(1+margin), budget)
        if nb:
            raw_value = pop.value[buyers, None] - pop.relocation_cost[
                buyers, None
            ] * (np.arange(C)[None, :] != home_b[:, None])
            margins_eff = pop.margins() if margin is None else margin
            pi_nc = np.minimum(
                np.minimum(
                    raw_value,
                    believed_b * (1.0 + margins_eff[buyers])[:, None],
                ),
                pop.budget[buyers, None],
            )
            if pi_scale is not None:
                pi_nc = pi_nc * pi_scale[buyers, None]
            bcc = np.where(valid, bc, 0).astype(np.int32)
            bpos = (starts[buy_row][:, :, None] + t_ar[None, None, :])[valid]
            flat_idx[bpos] = (
                bcc[valid][:, None] * np.int32(T) + t_ar.astype(np.int32)[None, :]
            )
            flat_val[bpos] = pop.req[buyers].astype(np.float32)[
                np.nonzero(valid)[0]
            ]
            mask[buy_row] = valid
            pi_mat[buy_row] = np.where(
                valid,
                np.take_along_axis(pi_nc, bcc, axis=1).astype(np.float32),
                np.float32(-np.inf),
            )
            row_agent[buy_row] = buyers
            bundle_cluster[buy_row] = np.where(valid, bc, -1)

        problem = csr_problem_from_arrays(
            flat_idx, flat_val, offsets, mask, pi_mat,
            base_cost=base_cost_flat, k_bound=max(T, 1), device=self.device,
        )
        return BidBook(
            problem=problem, pi_mat=pi_mat, row_kind=row_kind,
            row_agent=row_agent, sell_cluster=sell_cluster,
            bundle_cluster=bundle_cluster,
        )

    def _pack_bids_loop(
        self,
        psi_flat: np.ndarray,
        tilde_p: np.ndarray,
        base_cost_flat: np.ndarray,
        u_arb: np.ndarray,
        perm_keys: np.ndarray,
        pi_scale: np.ndarray | None = None,
        arbitrage: np.ndarray | None = None,
        margin: np.ndarray | None = None,
        dropout: np.ndarray | None = None,
        placed_override: np.ndarray | None = None,
        free: np.ndarray | None = None,
    ) -> BidBook:
        """The reference's per-agent packer (the pre-vectorization path), kept
        as the parity oracle: it consumes the same pre-drawn randomness and
        packs the same rows, bundles and prices as
        :meth:`_pack_bids_vectorized`, into the K-padded encoding.  O(N)
        Python — tests and small economies only."""
        pop = self.pop
        T, C = self.T, self.C
        t_arange = np.arange(T)
        arb = pop.arbitrage if arbitrage is None else arbitrage
        believed = bundle_cluster_costs(pop.req, self.belief)
        margins = pop.margins() if margin is None else margin
        sparse_rows: list[list[tuple[np.ndarray, np.ndarray]]] = []
        pi_rows: list[np.ndarray] = []
        kinds: list[tuple] = []  # (agent_idx, kind, cluster list)

        placed_arr = pop.placed if placed_override is None else placed_override
        if free is None:
            free = np.maximum(self.capacity - self.usage, 0.0).reshape(-1)
        for r in range(self.R):
            if free[r] <= 1e-9:
                continue
            sparse_rows.append([(np.array([r], np.int32), np.array([-free[r]], np.float32))])
            pi_rows.append(np.array([-free[r] * float(tilde_p[r])], np.float32))
            kinds.append((-1, "op", [r // T]))

        max_b = 1
        for i in range(len(pop)):
            if dropout is not None and dropout[i]:
                continue  # bid-stream dropout: nothing submitted this epoch
            placed_i, home_i = int(placed_arr[i]), int(pop.home[i])
            req_i = pop.req[i]
            wants_placement = placed_i < 0
            sells = (
                placed_i >= 0
                and arb[i] > 0
                and u_arb[i] < arb[i]
                and psi_flat[self.pool_idx(placed_i, 0)] > 0.75
            )
            if sells:
                # trader: offer holdings at home, seek to re-buy elsewhere
                exp_rev = float(believed[i, placed_i])
                sparse_rows.append([((placed_i * T + t_arange).astype(np.int32),
                                     (-req_i).astype(np.float32))])
                pi_rows.append(np.array([-exp_rev * (1.0 - 0.15)], np.float32))
                kinds.append((i, "sell", [placed_i]))
                wants_placement = True  # now needs a new home
            if not wants_placement:
                continue
            n_reach = min(max(1, int(round(float(pop.mobility[i]) * C))), C)
            order = np.argsort(perm_keys[i], kind="stable")
            reach = sorted(order[:n_reach].tolist(), key=lambda c: 0 if c == home_i else 1)
            if home_i >= 0 and home_i not in reach:
                reach = [home_i] + reach[: max(0, n_reach - 1)]
            bundles, pis = [], []
            for c in reach:
                believed_c = float(believed[i, c])
                raw_value = float(pop.value[i]) - (
                    float(pop.relocation_cost[i]) if c != home_i else 0.0
                )
                # bid: value capped by belief·(1+margin) — early epochs bid
                # near private value (wild), later epochs track the market
                pi = min(raw_value, believed_c * (1.0 + float(margins[i])),
                         float(pop.budget[i]))
                if pi_scale is not None:
                    pi = pi * float(pi_scale[i])
                bundles.append(((c * T + t_arange).astype(np.int32), req_i.astype(np.float32)))
                pis.append(pi)
            sparse_rows.append(bundles)
            pi_rows.append(np.asarray(pis, np.float32))
            kinds.append((i, "buy", reach))
            max_b = max(max_b, len(bundles))

        U = len(sparse_rows)
        max_b = max(max_b, max(len(b) for b in sparse_rows))
        pi_mat = np.full((U, max_b), -np.inf, np.float32)
        for u, pis_u in enumerate(pi_rows):
            pi_mat[u, : len(pis_u)] = pis_u

        problem = pack_bids_sparse(sparse_rows, pi_mat, base_cost=base_cost_flat,
                                   k_max=max(T, 1), device=self.device)
        row_kind = np.full((U,), KIND_BUY, np.int8)
        row_agent = np.full((U,), -1, np.int64)
        sell_cluster = np.full((U,), -1, np.int64)
        bundle_cluster = np.full((U, max_b), -1, np.int64)
        for u, (aidx, kind, cluster_list) in enumerate(kinds):
            if kind == "op":
                row_kind[u] = KIND_OP
            elif kind == "sell":
                row_kind[u] = KIND_SELL
                row_agent[u] = aidx
                sell_cluster[u] = cluster_list[0]
            else:
                row_agent[u] = aidx
                bundle_cluster[u, : len(cluster_list)] = cluster_list
        return BidBook(
            problem=problem, pi_mat=pi_mat, row_kind=row_kind,
            row_agent=row_agent, sell_cluster=sell_cluster,
            bundle_cluster=bundle_cluster,
        )

    def _draw_and_pack(
        self,
        psi_flat: np.ndarray,
        tilde_p: np.ndarray,
        base_cost_flat: np.ndarray,
        dry_run: bool,
        dropout: np.ndarray | None = None,
        placed_override: np.ndarray | None = None,
        free: np.ndarray | None = None,
    ) -> BidBook:
        """Draw epoch randomness, fold in policy actions, pack the book."""
        u_arb, perm_keys = self._draw_bid_randomness()
        perm_keys, pi_scale, arb, margin = self._apply_policies(
            perm_keys, dry_run
        )
        pack = self._pack_bids_vectorized if self.packer == "vectorized" else self._pack_bids_loop
        return pack(
            psi_flat, tilde_p, base_cost_flat, u_arb, perm_keys,
            pi_scale=pi_scale, arbitrage=arb, margin=margin,
            dropout=dropout, placed_override=placed_override, free=free,
        )

    def pack_bid_book(self) -> BidBook:
        """Pack the coming epoch's bid book without settling (consumes RNG).

        Mostly useful for inspection and the parity suite; ``run_epoch``
        draws and packs internally.  Policy actions are applied but not
        persisted (sticky-reach storage is untouched), like a dry run —
        and fault overlays (dropout, capacity loss) are applied as pure
        views, so the book matches what the next binding epoch would pack.
        """
        draw, cap_eff, usage_eff, placed_ov, _, _, _ = self._epoch_view()
        psi_flat = (
            np.clip(usage_eff / np.maximum(cap_eff, 1e-9), 0.0, 1.0)
            .reshape(-1)
            .copy()
        )
        if draw is None:
            tilde_p = reserve_prices(self.pools(), self.weighting)
            free = None
        else:
            tilde_p = reputation_weighted_reserve(
                self._pools_from(cap_eff, usage_eff),
                self.weighting,
                reliability=self.pool_reliability,
                discount=self.reliability_discount,
            )
            free = np.maximum(cap_eff - usage_eff, 0.0).reshape(-1)
        base_cost_flat = np.tile(self.base_cost_rt, self.C).astype(np.float32)
        return self._draw_and_pack(
            psi_flat, tilde_p, base_cost_flat, dry_run=True,
            dropout=None if draw is None else draw.dropout,
            placed_override=placed_ov, free=free,
        )

    # -- one auction epoch ---------------------------------------------------
    def run_epoch(self, dry_run: bool = False) -> EpochStats:
        """Settle one auction epoch and apply allocations.

        ``dry_run=True`` settles the same bid book but is side-effect free:
        ``usage`` / ``belief`` / agent state / ``price_history`` are never
        touched (the dry-run branch returns before any mutation), and the RNG
        state consumed while drawing the bid book is restored on return — so a
        following binding ``run_epoch`` draws the identical bid book and
        settles to bit-identical prices.
        """
        settle = self._settle_epoch_fused if self.fused else self._settle_epoch
        if dry_run:
            rng_state = self.rng.bit_generator.state
            try:
                return settle(dry_run=True)
            finally:
                self.rng.bit_generator.state = rng_state
        return settle(dry_run=False)

    def _warm_seed(self, tilde_p: np.ndarray) -> np.ndarray:
        """Next clock's starting prices under warm starts.

        The base seed is ``max(p_prev, reserve)`` — the last binding epoch's
        clearing point floored at this epoch's reserve curve, so the
        ascending clock re-discovers only what actually moved.  With
        ``warm_decay < 1``, pools that saw *no buy fills* last epoch decay
        their memory toward the reserve curve instead:
        ``reserve + warm_decay·max(p_prev − reserve, 0)``.  A one-epoch
        demand spike on a pool nobody then trades in thus bleeds out of the
        seed geometrically (per idle epoch) rather than pinning the pool's
        start price high indefinitely; the reserve stays a hard floor
        either way.  ``warm_decay == 1`` reproduces the base seed exactly
        (the pre-decay warm path, pinned by the warm goldens).
        """
        p_prev = self.price_history[-1]
        seed = np.maximum(p_prev, tilde_p)
        if self.warm_decay < 1.0 and self._last_filled is not None:
            idle = ~self._last_filled
            decayed = tilde_p + self.warm_decay * np.maximum(
                p_prev - tilde_p, 0.0
            )
            seed = np.where(idle, decayed, seed)
        return seed

    def _settle_epoch(self, dry_run: bool) -> EpochStats:
        churn_rej, churn_units, churn_short = self._consume_churn_counters(
            dry_run
        )
        draw, cap_eff, usage_eff, placed_ov, pre_evict, pre_claw, pre_comp = (
            self._epoch_view()
        )
        if not dry_run and pre_evict is not None:
            # commit the pre-auction quota clawback: a region fault below
            # current usage evicts holders (LIFO) with compensation at the
            # last settled prices; they re-enter this epoch's book as buyers
            self.pop.placed[pre_evict] = -1
            self.usage = usage_eff
        psi_flat = (
            np.clip(usage_eff / np.maximum(cap_eff, 1e-9), 0.0, 1.0)
            .reshape(-1)
            .copy()
        )
        if draw is None:
            tilde_p = reserve_prices(self.pools(), self.weighting)
            free_flat = None
        else:
            # reputation-weighted reserves: the reliability EMA discounts
            # each pool's effective capacity, pricing unreliable supply up
            tilde_p = reputation_weighted_reserve(
                self._pools_from(cap_eff, usage_eff),
                self.weighting,
                reliability=self.pool_reliability,
                discount=self.reliability_discount,
            )
            free_flat = np.maximum(cap_eff - usage_eff, 0.0).reshape(-1)
        base_cost_flat = np.tile(self.base_cost_rt, self.C).astype(np.float32)

        book = self._draw_and_pack(
            psi_flat, tilde_p, base_cost_flat, dry_run,
            dropout=None if draw is None else draw.dropout,
            placed_override=placed_ov, free=free_flat,
        )
        if book.num_rows == 0:
            raise RuntimeError(
                "empty bid book: no operator supply and no bidding agents"
            )
        problem = book.problem
        dropped = (
            0 if draw is None or draw.dropout is None else int(draw.dropout.sum())
        )

        # Settlement demand: the blocked fold (see __init__).  Start prices
        # cross to the device as float32, where the reference's device
        # arrays hold them.
        warm = self.warm_start and bool(self.price_history)
        seed = self._warm_seed(np.asarray(tilde_p)) if warm else tilde_p
        start = self._to_device(seed)

        result = clock_auction(problem, start, self.clock, demand_fn=self.demand_fn)
        # bounded-retry escalation: a round-starved clock is re-run with a
        # doubled budget and the adaptive schedule on, continuing from the
        # truncated trajectory (sound: the clock is ascending-only)
        escalations = 0
        cfg = self.clock
        while not bool(result.converged) and escalations < self.clock_retries:
            escalations += 1
            cfg = escalate_clock(cfg)
            result = clock_auction(problem, result.prices, cfg, demand_fn=self.demand_fn)
        sys_ok = all(verify_system(problem, result).values())
        surplus, trade = surplus_and_trade(problem, result)

        prices = result.prices.cpu().numpy()
        converged = bool(result.converged)
        if dry_run:
            return EpochStats(
                epoch=len(self.price_history), prices=prices,
                reserve=np.asarray(tilde_p), psi=psi_flat,
                price_ratio=prices / base_cost_flat,
                gamma_median=float("nan"), gamma_mean=float("nan"),
                pct_settled=float("nan"),
                buy_util_percentiles=np.empty(0), sell_util_percentiles=np.empty(0),
                migrations=0, surplus=float(surplus), value_of_trade=float(trade),
                rounds=int(result.rounds), converged=converged,
                system_ok=sys_ok, warm_started=warm,
                degraded=bool(
                    not converged
                    or escalations
                    or pre_evict is not None
                    or (draw is not None and draw.capacity_scale is not None)
                ),
                clock_escalations=escalations, dropped_bids=dropped,
                evictions=0 if pre_evict is None else int(pre_evict.sum()),
                clawback_units=pre_claw, compensation=pre_comp,
                arrivals_rejected=churn_rej,
                arrival_units_rejected=churn_units,
                release_shortfall_units=churn_short,
            )

        # proportional-rationing fallback: a still-unconverged epoch's
        # winning buys are scaled to fit the surviving capacity instead of
        # being silently clipped pool-wise
        ration = self.ration_fallback and not converged
        apply = (self._apply_settlement if self.packer == "vectorized"
                 else self._apply_settlement_loop)
        stats = apply(book, result, cap=cap_eff, ration=ration)

        post = {
            "seller_failures": 0, "failed_pools": 0,
            "evictions": 0, "clawback_units": 0.0, "compensation": 0.0,
        }
        if draw is not None:
            post = self._post_settlement_faults(draw, cap_eff, stats)
        self._last_cap_eff = cap_eff

        # -- learning: beliefs drift toward settled prices --------------------
        self.belief = 0.25 * self.belief + 0.75 * prices
        self.pop.epoch += 1
        self.price_history.append(prices)  # also next epoch's warm-start seed
        self._last_reserve = np.asarray(tilde_p)  # policy observation

        evictions = (
            0 if pre_evict is None else int(pre_evict.sum())
        ) + post["evictions"]
        degraded = bool(
            not converged
            or escalations
            or stats["rationed_rows"]
            or evictions
            or post["seller_failures"]
            or post["failed_pools"]
            or pre_evict is not None
            or (draw is not None and draw.capacity_scale is not None)
        )
        return EpochStats(
            epoch=len(self.price_history) - 1,
            prices=prices,
            reserve=np.asarray(tilde_p),
            psi=psi_flat,
            price_ratio=prices / base_cost_flat,
            gamma_median=stats["gamma_median"],
            gamma_mean=stats["gamma_mean"],
            pct_settled=stats["pct_settled"],
            buy_util_percentiles=stats["buy_util_pct"],
            sell_util_percentiles=stats["sell_util_pct"],
            migrations=stats["migrations"],
            surplus=float(surplus),
            value_of_trade=float(trade),
            rounds=int(result.rounds),
            converged=converged,
            system_ok=sys_ok,
            warm_started=warm,
            degraded=degraded,
            clock_escalations=escalations,
            rationed_rows=stats["rationed_rows"],
            dropped_bids=dropped,
            seller_failures=post["seller_failures"],
            failed_pools=post["failed_pools"],
            evictions=evictions,
            clawback_units=pre_claw + post["clawback_units"],
            compensation=pre_comp + post["compensation"],
            arrivals_rejected=churn_rej,
            arrival_units_rejected=churn_units,
            release_shortfall_units=churn_short,
        )

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host prices → float32 tensor on the economy's device."""
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

    # -- fused epoch path (.fused) --------------------------------------------
    def invalidate_device_state(self) -> None:
        """Force the fused path to upload the host mirrors again next epoch.

        The fused path keeps market state on the device; the mutation sites
        it knows about (arrivals, departures, fault clawbacks) mark it dirty
        themselves.  Call this after mutating ``pop`` / ``usage`` /
        ``belief`` directly from outside the Economy API."""
        self._state_dirty = True

    def sync_host_mirrors(self) -> None:
        """Bring the device state back into the host mirrors (``pop.placed``,
        ``pop.home``, ``pop.fill_rate``, ``usage``, ``belief``).  Every
        binding fused epoch already adopts its outputs; a state tree taken
        from a fused economy calls this first all the same, so it reads what
        the device holds.  A dirty device state is stale, and is left."""
        st = self._device_state
        if st is None or self._state_dirty:
            return
        n = len(self.pop)
        self.pop.placed = _host(st.placed)[:n]
        self.pop.home = _host(st.home)[:n]
        self.pop.fill_rate = _host(st.fill_rate)[:n]
        self.usage = _host(st.usage)
        self.belief = _host(st.belief)

    def _fused_cap(self) -> int:
        """Agent capacity the fused program is (or should be) built for:
        ``len(pop)``, or with ``fused_slack`` a power of two that only grows
        (by doubling), so arrivals within the slack and any departure keep
        the built program; dead slots ride along neutral in allocations
        (their presence is zeroed through dropout)."""
        n = len(self.pop)
        if not self.fused_slack:
            return n
        cap = self._fused_n if self._fused_n is not None else 0
        if cap >= n:
            return cap
        cap = max(cap, 16)
        while cap < n:
            cap *= 2
        return cap

    def _fused_program(self):
        n = self._fused_cap()
        if self._fused_fn is None or self._fused_n != n:
            self._fused_fn = build_fused_epoch(
                num_agents=n, num_clusters=self.C, num_rtypes=self.T,
                clock=self.clock, clock_retries=self.clock_retries,
                ration_fallback=self.ration_fallback, settle_blocks=self.settle_blocks,
                backend=self.fused_backend,
            )
            self._fused_n = n
            self._state_dirty = True
            self._device_const = None
        return self._fused_fn

    def _pad_agents(self, a: np.ndarray, fill) -> np.ndarray:
        """Pad a per-agent array's leading axis to the built fused capacity
        (no-op without slack, or when the population fills the capacity)."""
        cap = self._fused_n if self._fused_n is not None else len(self.pop)
        n = a.shape[0]
        if n == cap:
            return a
        pad = np.full((cap - n,) + a.shape[1:], fill, dtype=a.dtype)
        return np.concatenate([a, pad], axis=0)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the economy's device (never a view: the
        fused program updates its state tensors in place)."""
        return torch.from_numpy(np.array(a)).to(self.device)

    def _fused_const(self) -> tuple:
        if self._device_const is None or self._state_dirty:
            pop = self.pop
            self._device_const = tuple(
                self._upload(self._pad_agents(np.asarray(a), 0))
                for a in (pop.req, pop.value, pop.relocation_cost, pop.mobility, pop.budget)
            )
        return self._device_const

    def _fused_state(self) -> DeviceMarketState:
        if self._device_state is None or self._state_dirty:
            self._fused_const()  # refresh the immutables alongside
            self._device_state = DeviceMarketState.from_host(
                self.pop, self.usage, self.belief, capacity=self._fused_n, device=self.device
            )
            self._state_dirty = False
        return self._device_state

    def _fused_prepare(self, dry_run: bool) -> dict:
        """Host half of a fused epoch: faults view and pre-claw commit,
        reserve curve, warm seed, epoch randomness, policy overlays —
        everything the device program consumes, with neutral defaults for
        every overlay, so every epoch runs the same stages."""
        pop = self.pop
        n, C, T = len(pop), self.C, self.T
        churn = self._consume_churn_counters(dry_run)
        draw, cap_eff, usage_eff, placed_ov, pre_evict, pre_claw, pre_comp = (
            self._epoch_view()
        )
        if not dry_run and pre_evict is not None:
            self.pop.placed[pre_evict] = -1
            self.usage = usage_eff
            self._state_dirty = True
        psi_flat = (
            np.clip(usage_eff / np.maximum(cap_eff, 1e-9), 0.0, 1.0)
            .reshape(-1)
            .copy()
        )
        if draw is None:
            tilde_p = reserve_prices(self.pools(), self.weighting)
            free_basis = self.capacity
        else:
            tilde_p = reputation_weighted_reserve(
                self._pools_from(cap_eff, usage_eff),
                self.weighting,
                reliability=self.pool_reliability,
                discount=self.reliability_discount,
            )
            free_basis = cap_eff
        base_cost_flat = np.tile(self.base_cost_rt, C).astype(np.float32)
        warm = self.warm_start and bool(self.price_history)
        start = (
            self._warm_seed(np.asarray(tilde_p)) if warm else np.asarray(tilde_p)
        ).astype(np.float32)

        u_arb, perm_keys = self._draw_bid_randomness()
        perm_keys, pi_scale, arb, margin = self._apply_policies(perm_keys, dry_run)
        if pi_scale is None:
            pi_scale = np.ones(n, np.float64)
        if arb is None:
            arb = pop.arbitrage
        if margin is None:
            margin = pop.margins()
        dropout = (
            np.zeros(n, bool)
            if draw is None or draw.dropout is None
            else np.asarray(draw.dropout, bool)
        )
        dropped = 0 if draw is None or draw.dropout is None else int(draw.dropout.sum())

        # host twin of the device's presence masks: the staged empty-book
        # guard, plus the bid counts pct_settled needs
        placed_eff = placed_ov if (dry_run and placed_ov is not None) else pop.placed
        free_host = np.maximum(free_basis - usage_eff, 0.0).reshape(-1)
        psi_home0 = psi_flat[np.clip(placed_eff, 0, C - 1) * T]
        sells = ((placed_eff >= 0) & (arb > 0) & (u_arb < arb) & (psi_home0 > 0.75)) & ~dropout
        wants = ((placed_eff < 0) | sells) & ~dropout
        n_op = int((free_host > 1e-9).sum())
        if n_op + int(sells.sum()) + int(wants.sum()) == 0:
            raise RuntimeError("empty bid book: no operator supply and no bidding agents")

        return {
            "draw": draw, "cap_eff": cap_eff, "usage_eff": usage_eff,
            "free_basis": free_basis, "psi_flat": psi_flat,
            "tilde_p": np.asarray(tilde_p), "base_cost_flat": base_cost_flat,
            "start": start, "warm": warm, "dropped": dropped,
            "pre_evict": pre_evict, "pre_claw": pre_claw, "pre_comp": pre_comp,
            "epoch_index": len(self.price_history),
            "u_arb": u_arb, "perm_keys": perm_keys, "pi_scale": pi_scale,
            "arb": arb, "margin": margin, "dropout": dropout,
            "sells": sells, "wants": wants, "placed_eff": placed_eff,
            "home_pre": pop.home, "churn": churn,
            "util_pct": None if dry_run else self._util_percentiles(),
        }

    # per-agent fused inputs and their slack-slot fill values: dropout=True
    # zeroes a dead slot's presence, u_arb=1 ≥ arb=0 keeps the sell coin
    # from firing, and the rest are neutral under ~present
    _FUSED_AGENT_INPUTS = (
        ("u_arb", 1.0), ("perm_keys", 0.5), ("pi_scale", 1.0),
        ("arb", 0.0), ("margin", 0.0), ("dropout", True),
    )
    # per-agent fused outputs, sliced back to the live population under slack
    _FUSED_AGENT_OUTPUTS = (
        "sells", "wants", "won_sell", "won_buy", "pay_sell", "pay_buy",
        "pi_sell", "pi_buy", "buy_cluster", "buy_scale",
        "placed_new", "home_new", "fill_new",
    )

    def _fused_dispatch(self, prep: dict, dry_run: bool) -> dict:
        """Upload the epoch's inputs and run the fused program.  On the card
        it returns once the clock has settled, with the settle stage queued
        behind it."""
        fn = self._fused_program()
        n = len(self.pop)
        if dry_run:
            # ephemeral state copies: the program updates them in place,
            # the persistent device state and host mirrors are untouched
            self._fused_const()
            pad_i = np.full(max(self._fused_n - n, 0), -1, np.int64)
            state = (
                self._upload(np.concatenate([prep["placed_eff"], pad_i])),
                self._upload(np.concatenate([self.pop.home, pad_i])),
                self._upload(self._pad_agents(self.pop.fill_rate, 1.0)),
                self._upload(prep["usage_eff"]),
                self._upload(self.belief),
            )
        else:
            state = self._fused_state()
        inputs = tuple(
            self._upload(self._pad_agents(np.asarray(prep[k]), fill))
            for k, fill in self._FUSED_AGENT_INPUTS
        ) + tuple(
            self._upload(prep[k])
            for k in ("cap_eff", "free_basis", "tilde_p", "start", "base_cost_flat")
        )
        out = fn(self._device_const, state, inputs)
        if self._fused_n != n:
            for k in self._FUSED_AGENT_OUTPUTS:
                out[k] = out[k][:n]
        return out

    def _fused_adopt(self, prep: dict, out: dict) -> None:
        """Sync the host mirrors from the epoch's outputs (waits for the
        device): only what the next epoch's host half reads — mirrors, price
        history, warm-seed staleness flags.  Stats assembly stays in
        :meth:`_fused_finalize`, which in pipeline mode runs while the next
        epoch is already on the device."""
        prices = _host(out["prices"])
        self.pop.placed = _host(out["placed_new"])
        self.pop.home = _host(out["home_new"])
        self.pop.fill_rate = _host(out["fill_new"])
        self.usage = _host(out["usage_new"])
        self.belief = _host(out["belief_new"])
        self._last_cap_eff = prep["cap_eff"]
        self.pop.epoch += 1
        self.price_history.append(prices)
        self._last_reserve = np.asarray(prep["tilde_p"])
        won_buy = _host(out["won_buy"])
        buy_agents = np.flatnonzero(won_buy)
        bc = _host(out["buy_cluster"])[buy_agents]
        filled = np.zeros(self.R, bool)
        if bc.size:
            pools = bc[:, None] * self.T + np.arange(self.T)[None, :]
            filled[pools[self.pop.req[buy_agents] > 0]] = True
        self._last_filled = filled
        prep["prices"] = prices
        prep["buy_agents"] = buy_agents
        prep["bc"] = bc

    def _fused_finalize(self, prep: dict, out: dict, dry_run: bool) -> EpochStats:
        """Assemble EpochStats from the epoch's outputs and ``prep``.

        Reads only ``prep`` and ``out`` (never live mirrors), so in pipeline
        mode it can run after the next epoch has been dispatched and
        adopted.  Premiums rebuild the staged row order — agent rows
        ascending, sell row before buy row — so the order-dependent
        ``np.mean`` fold matches the staged path."""
        prices = prep.get("prices")
        if prices is None:
            prices = _host(out["prices"])
        converged = bool(out["converged"])
        sys_ok = bool(out["system_ok"])
        rounds = int(out["rounds"])
        escalations = int(out["escalations"])
        surplus = float(out["surplus"])
        trade = float(out["value_of_trade"])
        draw, pre_evict = prep["draw"], prep["pre_evict"]
        if dry_run:
            return EpochStats(
                epoch=prep["epoch_index"], prices=prices,
                reserve=prep["tilde_p"], psi=prep["psi_flat"],
                price_ratio=prices / prep["base_cost_flat"],
                gamma_median=float("nan"), gamma_mean=float("nan"),
                pct_settled=float("nan"),
                buy_util_percentiles=np.empty(0), sell_util_percentiles=np.empty(0),
                migrations=0, surplus=surplus, value_of_trade=trade,
                rounds=rounds, converged=converged, system_ok=sys_ok, warm_started=prep["warm"],
                degraded=bool(
                    not converged
                    or escalations
                    or pre_evict is not None
                    or (draw is not None and draw.capacity_scale is not None)
                ),
                clock_escalations=escalations, dropped_bids=prep["dropped"],
                evictions=0 if pre_evict is None else int(pre_evict.sum()),
                clawback_units=prep["pre_claw"], compensation=prep["pre_comp"],
                arrivals_rejected=prep["churn"][0],
                arrival_units_rejected=prep["churn"][1],
                release_shortfall_units=prep["churn"][2],
            )

        won_sell, won_buy = _host(out["won_sell"]), _host(out["won_buy"])
        pay_s = _host(out["pay_sell"]).astype(np.float64)
        pay_b = _host(out["pay_buy"]).astype(np.float64)
        pi_s = _host(out["pi_sell"]).astype(np.float64)
        pi_b = _host(out["pi_buy"]).astype(np.float64)
        pi_a = np.stack([pi_s, pi_b], axis=1).reshape(-1)
        pay_a = np.stack([pay_s, pay_b], axis=1).reshape(-1)
        won_a = np.stack([won_sell, won_buy], axis=1).reshape(-1)
        g = won_a & (np.abs(pay_a) > 1e-9)
        gammas = np.abs(pi_a[g] - pay_a[g]) / np.abs(pay_a[g])

        sell_agents = np.flatnonzero(won_sell)
        sc = prep["placed_eff"][sell_agents]
        buy_agents, bc, home_pre = prep["buy_agents"], prep["bc"], prep["home_pre"]
        migrations = int(((home_pre[buy_agents] >= 0) & (home_pre[buy_agents] != bc)).sum())
        n_agent_bids = int(prep["sells"].sum() + prep["wants"].sum())
        n_agent_wins = int(won_sell.sum() + won_buy.sum())
        rationed = int(out["rationed_rows"])
        util_pct = prep["util_pct"]

        post = {
            "seller_failures": 0, "failed_pools": 0,
            "evictions": 0, "clawback_units": 0.0, "compensation": 0.0,
        }
        if draw is not None:
            buy_scale = _host(out["buy_scale"])
            post = self._post_settlement_faults(
                draw, prep["cap_eff"],
                {
                    "sell_agents": sell_agents, "sell_clusters": sc,
                    "buy_agents": buy_agents, "buy_clusters": bc,
                    "buy_scale": buy_scale[buy_agents],
                    "buy_payments": pay_b[buy_agents],
                },
            )
            self._state_dirty = True  # the post-fault clawback mutated mirrors

        evictions = (0 if pre_evict is None else int(pre_evict.sum())) + post["evictions"]
        degraded = bool(
            not converged
            or escalations
            or rationed
            or evictions
            or post["seller_failures"]
            or post["failed_pools"]
            or pre_evict is not None
            or (draw is not None and draw.capacity_scale is not None)
        )
        return EpochStats(
            epoch=prep["epoch_index"],
            prices=prices,
            reserve=prep["tilde_p"],
            psi=prep["psi_flat"],
            price_ratio=prices / prep["base_cost_flat"],
            gamma_median=float(np.median(gammas)) if gammas.size else float("nan"),
            gamma_mean=float(np.mean(gammas)) if gammas.size else float("nan"),
            pct_settled=100.0 * n_agent_wins / max(n_agent_bids, 1),
            buy_util_percentiles=util_pct[bc] if bc.size else np.empty(0),
            sell_util_percentiles=util_pct[sc] if sc.size else np.empty(0),
            migrations=migrations,
            surplus=surplus,
            value_of_trade=trade,
            rounds=rounds,
            converged=converged,
            system_ok=sys_ok,
            warm_started=prep["warm"],
            degraded=degraded,
            clock_escalations=escalations,
            rationed_rows=rationed,
            dropped_bids=prep["dropped"],
            seller_failures=post["seller_failures"],
            failed_pools=post["failed_pools"],
            evictions=evictions,
            clawback_units=prep["pre_claw"] + post["clawback_units"],
            compensation=prep["pre_comp"] + post["compensation"],
            arrivals_rejected=prep["churn"][0],
            arrival_units_rejected=prep["churn"][1],
            release_shortfall_units=prep["churn"][2],
        )

    def _settle_epoch_fused(self, dry_run: bool) -> EpochStats:
        prep = self._fused_prepare(dry_run)
        out = self._fused_dispatch(prep, dry_run)
        if not dry_run:
            self._fused_adopt(prep, out)
        return self._fused_finalize(prep, out, dry_run)

    def run_horizon(self, num_epochs: int) -> list[EpochStats]:
        """Run ``num_epochs`` binding epochs; with ``pipeline=True``, keep
        one epoch in flight.

        The pipelined loop dispatches epoch t+1 and only then assembles
        epoch t's EpochStats, so the host's numpy work (premiums, utilization
        percentiles) overlaps the device's settle stage of the next epoch.
        Stats are bit-identical to sequential ``run_epoch`` calls — same
        program, same inputs, only the host bookkeeping is reordered."""
        if not self.pipeline:
            return [self.run_epoch() for _ in range(num_epochs)]
        stats: list[EpochStats] = []
        pending: tuple[dict, dict] | None = None
        for _ in range(num_epochs):
            prep = self._fused_prepare(dry_run=False)
            out = self._fused_dispatch(prep, dry_run=False)
            if pending is not None:
                # the previous epoch's stats overlap this epoch's device
                # work; only adopt() below waits for the device
                stats.append(self._fused_finalize(*pending, dry_run=False))
            self._fused_adopt(prep, out)
            pending = (prep, out)
        if pending is not None:
            stats.append(self._fused_finalize(*pending, dry_run=False))
        return stats

    def _commit_usage(
        self,
        sell_agents: np.ndarray,
        sc: np.ndarray,
        buy_agents: np.ndarray,
        bc: np.ndarray,
        cap: np.ndarray,
        ration: bool,
    ) -> tuple[np.ndarray, int]:
        """Commit the settled usage delta; returns (buy_scale, rationed_rows).

        All settled deltas (trader give-backs, buyer additions, movers'
        old-home releases) accumulate into one per-pool delta and the result
        is clipped to [0, cap] — order-independent, so the outcome does not
        depend on agent index order.  With ``ration`` on, winning buys into
        a still-over-demanded pool are scaled by the pool's room/claim
        fraction (bundle-consistent: one scale per agent, the min over its
        resource types) instead of silently clipped — proportional
        rationing, the degraded-mode fallback for non-converged epochs.
        """
        pop = self.pop
        delta = np.zeros_like(self.usage)
        np.add.at(delta, sc, -pop.req[sell_agents])
        placed_eff = pop.placed.copy()
        placed_eff[sell_agents] = -1
        old = placed_eff[buy_agents]
        move = (old >= 0) & (old != bc)
        scale = np.ones(len(buy_agents), np.float64)
        rationed = 0
        if ration and len(buy_agents):
            released = delta.copy()
            np.add.at(released, old[move], -pop.req[buy_agents][move])
            room = np.maximum(cap - np.maximum(self.usage + released, 0.0), 0.0)
            claim = np.zeros_like(self.usage)
            np.add.at(claim, bc, pop.req[buy_agents])
            frac = np.where(
                claim > 1e-12,
                np.minimum(room / np.maximum(claim, 1e-12), 1.0),
                1.0,
            )
            per = np.where(pop.req[buy_agents] > 0, frac[bc], 1.0)
            scale = per.min(axis=1)
            rationed = int((scale < 1.0 - 1e-12).sum())
        np.add.at(delta, bc, scale[:, None] * pop.req[buy_agents])
        np.add.at(delta, old[move], -pop.req[buy_agents][move])
        self.usage = np.clip(self.usage + delta, 0.0, cap)
        return scale, rationed

    def _apply_settlement(
        self,
        book: BidBook,
        result,
        cap: np.ndarray | None = None,
        ration: bool = False,
    ) -> dict:
        """Apply won allocations to population + usage, fully vectorized.

        Usage commit semantics live in :meth:`_commit_usage`.
        """
        pop = self.pop
        if cap is None:
            cap = self.capacity
        won = result.won.cpu().numpy()
        chosen = result.chosen_bundle.cpu().numpy()
        payments = result.payments.cpu().numpy()
        U = book.num_rows
        kind = book.row_kind

        agent_rows = kind != KIND_OP
        win_rows = won & agent_rows
        n_agent_bids = int(agent_rows.sum())
        n_agent_wins = int(win_rows.sum())

        # premiums γ_u = |π − pay| / |pay| over winning agent rows (f64, as the
        # scalar reference computed them)
        pay64 = payments.astype(np.float64)
        pi_sel = book.pi_mat[np.arange(U), np.maximum(chosen, 0)].astype(np.float64)
        g_rows = win_rows & (np.abs(pay64) > 1e-9)
        gammas = np.abs(pi_sel[g_rows] - pay64[g_rows]) / np.abs(pay64[g_rows])

        util_pct = self._util_percentiles()  # pre-apply utilization ranks

        sell_rows = np.flatnonzero(win_rows & (kind == KIND_SELL))
        buy_rows = np.flatnonzero(win_rows & (kind == KIND_BUY))
        sell_agents = book.row_agent[sell_rows]
        sc = book.sell_cluster[sell_rows]
        buy_agents = book.row_agent[buy_rows]
        bc = book.bundle_cluster[buy_rows, chosen[buy_rows]]

        migrations = int(
            ((pop.home[buy_agents] >= 0) & (pop.home[buy_agents] != bc)).sum()
        )

        buy_scale, rationed = self._commit_usage(
            sell_agents, sc, buy_agents, bc, cap, ration
        )

        pop.placed[sell_agents] = -1
        pop.placed[buy_agents] = bc
        pop.home[buy_agents] = bc

        # policy feedback: per-agent buy-fill EMA (every agent that entered a
        # buy row, won or lost) and per-pool buy-fill flags (the staleness
        # signal the warm-seed decay keys off)
        buy_rows_all = np.flatnonzero(kind == KIND_BUY)
        ba = book.row_agent[buy_rows_all]
        pop.fill_rate[ba] = (1.0 - FILL_EMA) * pop.fill_rate[ba] + (
            FILL_EMA * won[buy_rows_all].astype(np.float64)
        )
        filled = np.zeros(self.R, bool)
        if bc.size:
            pools = bc[:, None] * self.T + np.arange(self.T)[None, :]
            filled[pools[pop.req[buy_agents] > 0]] = True
        self._last_filled = filled

        return {
            "gamma_median": float(np.median(gammas)) if gammas.size else float("nan"),
            "gamma_mean": float(np.mean(gammas)) if gammas.size else float("nan"),
            "pct_settled": 100.0 * n_agent_wins / max(n_agent_bids, 1),
            "buy_util_pct": util_pct[bc] if bc.size else np.empty(0),
            "sell_util_pct": util_pct[sc] if sc.size else np.empty(0),
            "migrations": migrations,
            "rationed_rows": rationed,
            "sell_agents": sell_agents,
            "sell_clusters": sc,
            "buy_agents": buy_agents,
            "buy_clusters": bc,
            "buy_scale": buy_scale,
            "buy_payments": pay64[buy_rows],
        }

    def _apply_settlement_loop(
        self,
        book: BidBook,
        result,
        cap: np.ndarray | None = None,
        ration: bool = False,
    ) -> dict:
        """Per-agent reference of :meth:`_apply_settlement` (the loop
        packer's apply).  Walks rows in order with scalar Python, but
        accumulates the usage delta in the same three passes (trader
        releases, buyer claims, movers' releases) as the vectorized apply,
        so both give bit-identical EpochStats."""
        pop = self.pop
        if cap is None:
            cap = self.capacity
        won = result.won.cpu().numpy()
        chosen = result.chosen_bundle.cpu().numpy()
        payments = result.payments.cpu().numpy()
        util_pct = self._util_percentiles()

        gammas: list[float] = []
        n_agent_bids = n_agent_wins = 0
        sell_pairs: list[tuple[int, int]] = []  # (agent, cluster)
        buy_pairs: list[tuple[int, int]] = []
        buy_pays: list[float] = []
        for u in range(book.num_rows):
            kind = book.row_kind[u]
            if kind == KIND_OP:
                continue
            n_agent_bids += 1
            if kind == KIND_BUY:
                a = int(book.row_agent[u])
                pop.fill_rate[a] = (1.0 - FILL_EMA) * pop.fill_rate[a] + (
                    FILL_EMA * float(won[u])
                )
            if not won[u]:
                continue
            n_agent_wins += 1
            pay = float(payments[u])
            pi_u = float(book.pi_mat[u, max(int(chosen[u]), 0)])
            if abs(pay) > 1e-9:
                gammas.append(abs(pi_u - pay) / abs(pay))
            a = int(book.row_agent[u])
            if kind == KIND_SELL:
                sell_pairs.append((a, int(book.sell_cluster[u])))
            else:
                buy_pairs.append((a, int(book.bundle_cluster[u, int(chosen[u])])))
                buy_pays.append(pay)

        migrations = 0
        for a, c in buy_pairs:
            if pop.home[a] >= 0 and pop.home[a] != c:
                migrations += 1
        sell_agents = np.asarray([a for a, _ in sell_pairs], np.int64)
        sc = np.asarray([c for _, c in sell_pairs], np.int64)
        buy_agents = np.asarray([a for a, _ in buy_pairs], np.int64)
        bc = np.asarray([c for _, c in buy_pairs], np.int64)
        buy_scale, rationed = self._commit_usage(sell_agents, sc, buy_agents, bc, cap, ration)

        for a, _ in sell_pairs:
            pop.placed[a] = -1
        for a, c in buy_pairs:
            pop.placed[a] = c
            pop.home[a] = c

        filled = np.zeros(self.R, bool)
        for a, c in buy_pairs:
            for t in range(self.T):
                if pop.req[a, t] > 0:
                    filled[c * self.T + t] = True
        self._last_filled = filled

        g = np.asarray(gammas, np.float64)
        return {
            "gamma_median": float(np.median(g)) if g.size else float("nan"),
            "gamma_mean": float(np.mean(g)) if g.size else float("nan"),
            "pct_settled": 100.0 * n_agent_wins / max(n_agent_bids, 1),
            "buy_util_pct": np.asarray([util_pct[c] for _, c in buy_pairs]),
            "sell_util_pct": np.asarray([util_pct[c] for _, c in sell_pairs]),
            "migrations": migrations,
            "rationed_rows": rationed,
            "sell_agents": sell_agents,
            "sell_clusters": sc,
            "buy_agents": buy_agents,
            "buy_clusters": bc,
            "buy_scale": buy_scale,
            "buy_payments": np.asarray(buy_pays, np.float64),
        }


@dataclasses.dataclass(frozen=True)
class FleetDistribution:
    """The fleet-agent distribution, shared between the per-agent builder
    (:func:`make_fleet_economy`) and the array builder
    (:func:`repro_torch.core.markets.fleet_population`) so the two cannot drift
    apart.  Tuples are (lo, hi) uniform ranges unless noted."""

    chip_sizes: tuple = (64.0, 128.0, 256.0, 512.0)  # job size choices
    hbm_per_chip: tuple = (8.0, 16.0)
    ici_per_chip: tuple = (40.0, 200.0)
    congested_home_frac: float = 0.7  # P(home drawn from congested clusters)
    placed_frac: float = 0.6  # P(agent starts holding resources at home)
    value_mult: tuple = (1.2, 3.5)  # private value / base-cost estimate
    relocation_mult: tuple = (0.02, 0.8)  # relocation cost / base-cost estimate
    mobility: tuple = (0.3, 1.0)
    margin0: tuple = (0.5, 2.0)
    arbitrage: tuple = (0.0, 0.5)


FLEET_DISTRIBUTION = FleetDistribution()


def make_fleet_economy(
    num_clusters: int = 6,
    num_agents: int = 48,
    seed: int = 0,
    congested_frac: float = 0.4,
    rtypes: Sequence[str] = ("tpu_chips", "hbm_gb", "ici_gbps"),
    base_cost: Sequence[float] = (10.0, 0.05, 0.2),
    **economy_kwargs,
) -> Economy:
    """A planet-wide TPU fleet: clusters with heterogeneous congestion, agents
    whose demand vectors look like LM training/serving jobs.

    Agent draws are per-agent (stream-stable with the seed corpus) — use
    :func:`repro_torch.core.markets.fleet_economy` for vectorized construction at
    10⁵–10⁶ agents.
    """
    d = FLEET_DISTRIBUTION
    rng = np.random.default_rng(seed)
    T = len(rtypes)
    capacity = np.zeros((num_clusters, T))
    for c in range(num_clusters):
        chips = float(rng.choice([1024, 2048, 4096]))
        capacity[c] = [chips, chips * 16.0, chips * 4 * 50.0]  # 16GB HBM, 4 links
    agents = []
    n_congested = int(round(congested_frac * num_clusters))
    for i in range(num_agents):
        chips = float(rng.choice(d.chip_sizes))
        req = np.array([
            chips,
            chips * rng.uniform(*d.hbm_per_chip),
            chips * rng.uniform(*d.ici_per_chip),
        ])
        cost_est = float((req * np.asarray(base_cost)).sum())
        home = (
            int(rng.integers(0, n_congested))
            if rng.random() < d.congested_home_frac
            else int(rng.integers(0, num_clusters))
        )
        placed = home if rng.random() < d.placed_frac else -1
        agents.append(
            Agent(
                name=f"job-{i}",
                req=req,
                value=cost_est * rng.uniform(*d.value_mult),
                home=home,
                placed=placed,
                relocation_cost=cost_est * rng.uniform(*d.relocation_mult),
                mobility=float(rng.uniform(*d.mobility)),
                margin0=float(rng.uniform(*d.margin0)),
                arbitrage=float(rng.uniform(*d.arbitrage)),
            )
        )
    eco = Economy(
        clusters=[f"cluster-{c}" for c in range(num_clusters)],
        rtypes=rtypes,
        capacity=capacity,
        base_cost=np.asarray(base_cost),
        agents=agents,
        seed=seed + 1,
        **economy_kwargs,
    )
    # pre-load congestion into the first n_congested clusters
    for c in range(n_congested):
        eco.usage[c] = np.maximum(eco.usage[c], 0.88 * eco.capacity[c])
    return eco
