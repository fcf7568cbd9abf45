"""Declarative scenario engine for the multi-epoch economy (the port of
``repro.core.scenarios``).

A :class:`Scenario` is an epoch count plus an epoch-indexed stream of
*events* — capacity loss/outage, demand flash-crowds, agent arrivals and
departures, base-cost changes, reserve-weighting swaps — applied to the
economy *between* auction epochs.  :func:`run_scenario` drives the loop,
logs every event, checks the economy's physical invariants (usage within
[0, capacity], placed-agent conservation under arrivals/departures), and
returns the full per-epoch :class:`~repro_torch.core.economy.EpochStats`
trajectory plus the cross-cluster utilization-spread series the paper's
Fig. 6 congestion-relief argument is about.

Events and the engine are the reference's numpy over the port's
:class:`~repro_torch.core.economy.Economy`: each epoch settles on the
economy's device (the partials-mode ``sparse_bid_eval`` kernel on the
card), so a scenario's trajectory is the reference's, bit for bit, but for
the payment-derived stats.  Events write the host arrays in place, as the
reference's do, and do not mark a fused economy's device state stale.

Adding a scenario: write a builder ``my_case(seed=0, *, device="cuda",
**kw) -> (Economy, Scenario)`` composing the event dataclasses below, and
register it in :data:`SCENARIOS`.  Events are frozen dataclasses with an
``epoch`` and an ``apply(economy) -> EventReport``; new event types only
need that contract.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np

from .economy import AgentPopulation, Economy, EpochStats, make_fleet_economy
from .faults import FaultModel, RegionFault
from .markets import FLEET_BASE_COST, FLEET_RTYPES, fleet_population
from .policies import (
    BudgetSmoothingPolicy,
    PriceChasingPolicy,
    StaticPolicy,
)
from .reserve import CURVE_FAMILIES


@dataclasses.dataclass(frozen=True)
class EventReport:
    """What one event did — consumed by the invariant checks and the log."""

    epoch: int
    description: str
    agents_added: int = 0
    agents_removed: int = 0
    placed_added: int = 0  # arrivals that came in already holding resources
    placed_removed: int = 0  # departures that freed held resources


@dataclasses.dataclass(frozen=True)
class CapacityShock:
    """Scale one cluster's capacity (scale<1: outage/decommission; >1: new
    hardware landing).  Held usage is clamped to the new capacity — jobs on
    failed machines lose them."""

    epoch: int
    cluster: int
    scale: float
    rtype: int | None = None  # None = every resource type

    def apply(self, eco: Economy) -> EventReport:
        sel = slice(None) if self.rtype is None else self.rtype
        eco.capacity[self.cluster, sel] *= self.scale
        eco.usage = np.minimum(eco.usage, eco.capacity)
        what = "all rtypes" if self.rtype is None else eco.rtypes[self.rtype]
        return EventReport(
            self.epoch,
            f"capacity x{self.scale:g} on {eco.clusters[self.cluster]} ({what})",
        )


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """Demand surge: scale the private values of a random fraction of agents
    (optionally only those homed in one cluster) — they bid like launches."""

    epoch: int
    value_scale: float
    fraction: float = 1.0
    cluster: int | None = None
    seed: int = 0

    def apply(self, eco: Economy) -> EventReport:
        rng = np.random.default_rng(self.seed)
        hit = rng.random(len(eco.pop)) < self.fraction
        if self.cluster is not None:
            hit &= eco.pop.home == self.cluster
        eco.pop.value[hit] *= self.value_scale
        where = "" if self.cluster is None else f" in {eco.clusters[self.cluster]}"
        return EventReport(
            self.epoch,
            f"flash crowd: value x{self.value_scale:g} for "
            f"{int(hit.sum())} agents{where}",
        )


@dataclasses.dataclass(frozen=True)
class Arrivals:
    """New teams join the economy (fleet-distribution draws; unplaced, so
    they enter the next auction as wild first-epoch bidders)."""

    epoch: int
    num_agents: int
    seed: int = 0
    value_mult: float = 1.0
    home: int | None = None

    def apply(self, eco: Economy) -> EventReport:
        if eco.T != 3:
            raise ValueError(
                "Arrivals draws fleet-shaped (3-rtype) agents; economy has "
                f"{eco.T} rtypes — add a pre-built AgentPopulation instead"
            )
        pop = fleet_population(
            self.num_agents, eco.C, seed=self.seed,
            value_mult=self.value_mult, home=self.home, placed_frac=0.0,
        )
        # add_agents may ration a pre-placed arrival down to unplaced when
        # its cluster lacks free capacity — count what was actually seated,
        # not what the cohort requested, or the conservation check drifts
        placed = eco.add_agents(pop)
        return EventReport(
            self.epoch,
            f"{self.num_agents} agents arrive",
            agents_added=self.num_agents,
            placed_added=placed,
        )


@dataclasses.dataclass(frozen=True)
class Departures:
    """A random fraction of agents (optionally only those placed in one
    cluster) leave; placed leavers free their held resources.  Always keeps
    at least one agent so the economy never empties."""

    epoch: int
    fraction: float
    cluster: int | None = None
    seed: int = 0

    def apply(self, eco: Economy) -> EventReport:
        rng = np.random.default_rng(self.seed)
        eligible = np.ones(len(eco.pop), bool)
        if self.cluster is not None:
            eligible = eco.pop.placed == self.cluster
        leave = eligible & (rng.random(len(eco.pop)) < self.fraction)
        if leave.all():
            leave[np.flatnonzero(leave)[-1]] = False  # keep the economy alive
        placed_removed = eco.remove_agents(leave)
        return EventReport(
            self.epoch,
            f"{int(leave.sum())} agents depart"
            + ("" if self.cluster is None else f" from {eco.clusters[self.cluster]}"),
            agents_removed=int(leave.sum()),
            placed_removed=placed_removed,
        )


@dataclasses.dataclass(frozen=True)
class BaseCostChange:
    """Operator re-costs one resource type (e.g. a power-price change) —
    shifts reserve prices and the Fig. 6 price-ratio baseline."""

    epoch: int
    rtype: int
    scale: float

    def apply(self, eco: Economy) -> EventReport:
        eco.base_cost_rt[self.rtype] *= self.scale
        return EventReport(
            self.epoch, f"base cost x{self.scale:g} on {eco.rtypes[self.rtype]}"
        )


@dataclasses.dataclass(frozen=True)
class WeightingSwap:
    """Swap the congestion-weighting curve (paper §IV) mid-run — the operator
    knob for how hard reserves punish congestion."""

    epoch: int
    weighting: str  # key into reserve.CURVE_FAMILIES

    def apply(self, eco: Economy) -> EventReport:
        eco.weighting = CURVE_FAMILIES[self.weighting]
        return EventReport(self.epoch, f"reserve weighting -> {self.weighting}")


Event = CapacityShock | FlashCrowd | Arrivals | Departures | BaseCostChange | WeightingSwap


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named experiment: how many epochs to run and what happens when."""

    name: str
    epochs: int
    events: tuple = ()
    description: str = ""

    def events_at(self, epoch: int) -> list:
        return [ev for ev in self.events if ev.epoch == epoch]


class RoundStarvedWarning(RuntimeWarning):
    """An epoch's clock hit ``max_rounds`` without clearing — the reported
    prices are a truncated trajectory, not a market equilibrium.  Raise
    ``max_rounds``, enable the adaptive schedule
    (``ClockConfig(alpha_growth=..., delta_decay=...)``), or warm-start the
    economy (``Economy(warm_start=True)``)."""


@dataclasses.dataclass
class ScenarioResult:
    scenario: Scenario
    stats: list  # one EpochStats per epoch
    events: list  # EventReports in application order
    util_spread: list  # len epochs+1: std of cluster mean-utilization

    @property
    def converged(self) -> bool:
        return all(s.converged for s in self.stats)

    @property
    def total_rounds(self) -> int:
        """Clock rounds summed over the run — the mechanism-cost headline a
        warm-started economy drives down (cf. Lai's hidden-cost critique)."""
        return int(sum(s.rounds for s in self.stats))

    @property
    def feasible(self) -> bool:
        return all(s.system_ok for s in self.stats)

    @property
    def total_migrations(self) -> int:
        return int(sum(s.migrations for s in self.stats))

    @property
    def spread_shrank(self) -> bool:
        """Did the market even out cross-cluster utilization (Fig. 6)?"""
        return self.util_spread[-1] < self.util_spread[0]


def _check_physical_invariants(
    eco: Economy, context: str, cap: np.ndarray | None = None
) -> None:
    """Usage within [0, cap] (cap defaults to nominal capacity; settlement
    checks pass the epoch's *surviving* capacity so a faulted region may
    never report phantom usage), population non-empty."""
    cap = eco.capacity if cap is None else cap
    if np.any(eco.usage < -1e-9) or np.any(eco.usage > cap + 1e-9):
        raise RuntimeError(f"usage out of [0, capacity] after {context}")
    if len(eco.pop) < 1:
        raise RuntimeError(f"economy emptied after {context}")


def _spread(eco: Economy) -> float:
    return float(np.std(eco.utilization().mean(axis=1)))


def run_scenario(
    eco: Economy,
    scenario: Scenario,
    check_invariants: bool = True,
    verbose: bool = False,
) -> ScenarioResult:
    """Apply each epoch's events, settle the auction, repeat.

    With ``check_invariants`` (default), every event and epoch is followed
    by the physical checks — usage within [0, capacity], population
    non-empty — and arrival/departure events must conserve the placed-agent
    count exactly (placed after == placed before + placed_added −
    placed_removed).
    """
    reports: list[EventReport] = []
    stats: list[EpochStats] = []
    spread = [_spread(eco)]
    for e in range(scenario.epochs):
        for ev in scenario.events_at(e):
            placed_before = int((eco.pop.placed >= 0).sum())
            rep = ev.apply(eco)
            reports.append(rep)
            if verbose:
                print(f"  [epoch {e}] event: {rep.description}")
            if check_invariants:
                _check_physical_invariants(eco, f"event {rep.description!r}")
                placed_after = int((eco.pop.placed >= 0).sum())
                expect = placed_before + rep.placed_added - rep.placed_removed
                if placed_after != expect:
                    raise RuntimeError(
                        f"placed-agent conservation broken by {rep.description!r}: "
                        f"{placed_before} -> {placed_after}, expected {expect}"
                    )
        s = eco.run_epoch()
        stats.append(s)
        if not s.converged and not eco.ration_fallback:
            # loud, not just a stats bit: every downstream number this epoch
            # (prices, premiums, migrations) describes a round-starved clock.
            # With the proportional-rationing fallback on, non-convergence is
            # a *handled* degraded mode instead — recorded in the epoch's
            # ``degraded``/``rationed_rows`` stats, not warned about.
            warnings.warn(
                f"scenario {scenario.name!r} epoch {e}: clock hit "
                f"max_rounds={eco.clock.max_rounds} without clearing "
                f"(rounds={s.rounds}) — prices are truncated, not settled",
                RoundStarvedWarning,
                stacklevel=2,
            )
        if check_invariants:
            _check_physical_invariants(
                eco, f"epoch {e} settlement", cap=eco._last_cap_eff
            )
        spread.append(_spread(eco))
        if verbose:
            print(
                f"  [epoch {e}] gamma_med={s.gamma_median:.4f} "
                f"settled={s.pct_settled:.0f}% migrations={s.migrations} "
                f"spread={spread[-1]:.3f} rounds={s.rounds} "
                f"converged={s.converged}"
                + (" warm" if s.warm_started else "")
            )
    return ScenarioResult(scenario, stats, reports, spread)


# ---------------------------------------------------------------------------
# Scenario library
# ---------------------------------------------------------------------------


def congestion_relief(seed: int = 3, epochs: int = 6, *, device="cuda", **eco_kwargs):
    """Paper Fig. 6: congested clusters priced high, repeated auctions drain
    them toward uniform utilization.  No events — the baseline mechanism."""
    eco = make_fleet_economy(seed=seed, device=device, **eco_kwargs)
    return eco, Scenario(
        "congestion_relief", epochs=epochs,
        description="repeated auctions relieve pre-loaded congestion",
    )


def cluster_drain(seed: int = 3, epochs: int = 6, *, device="cuda", **eco_kwargs):
    """Outage: cluster-0 loses 70% of its capacity after epoch 2; displaced
    demand must re-place into the survivors at market prices."""
    eco = make_fleet_economy(seed=seed, device=device, **eco_kwargs)
    return eco, Scenario(
        "cluster_drain", epochs=epochs,
        events=(CapacityShock(epoch=2, cluster=0, scale=0.3),),
        description="70% capacity loss on cluster-0 at epoch 2",
    )


def price_shock(seed: int = 3, epochs: int = 6, *, device="cuda", **eco_kwargs):
    """Chip base cost jumps 2.5x and the operator swaps to the logistic
    reserve curve mid-run — reserves and beliefs must re-converge."""
    eco = make_fleet_economy(seed=seed, device=device, **eco_kwargs)
    return eco, Scenario(
        "price_shock", epochs=epochs,
        events=(
            BaseCostChange(epoch=2, rtype=0, scale=2.5),
            WeightingSwap(epoch=2, weighting="logistic"),
        ),
        description="tpu_chips base cost x2.5 + logistic reserve curve at epoch 2",
    )


def flash_crowd(seed: int = 3, epochs: int = 6, *, device="cuda", **eco_kwargs):
    """Launch traffic: a wave of hot new bidders arrives at epoch 1, a
    quarter of the fleet churns out at epoch 4."""
    eco = make_fleet_economy(seed=seed, device=device, **eco_kwargs)
    return eco, Scenario(
        "flash_crowd", epochs=epochs,
        events=(
            Arrivals(epoch=1, num_agents=16, seed=seed + 100, value_mult=2.0),
            FlashCrowd(epoch=2, value_scale=1.5, fraction=0.5, seed=seed + 200),
            Departures(epoch=4, fraction=0.25, seed=seed + 300),
        ),
        description="hot arrivals at 1, value surge at 2, 25% churn at 4",
    )


def sticky_relocation(seed: int = 3, epochs: int = 6, *, device="cuda", **eco_kwargs):
    """Heterogeneous relocation costs: half the fleet is data-gravity-bound
    (10x relocation cost), half is free to move — the paper's 'some agents
    pay large premiums to stay' population, made extreme."""
    eco = make_fleet_economy(seed=seed, device=device, **eco_kwargs)
    rng = np.random.default_rng(seed + 1000)
    sticky = rng.random(len(eco.pop)) < 0.5
    eco.pop.relocation_cost[sticky] *= 10.0
    eco.pop.relocation_cost[~sticky] *= 0.1
    return eco, Scenario(
        "sticky_relocation", epochs=epochs,
        description="bimodal relocation costs: 50% sticky x10, 50% mobile x0.1",
    )


def migration_relief(seed: int = 3, epochs: int = 7, *, device="cuda", **eco_kwargs):
    """The paper's headline transition as *behavior*, not mechanism: a hot,
    over-reserve pool drains across epochs because price-chasing bidders
    re-bid toward under-utilized pools, while high-relocation-cost agents
    pay the congestion premium to stay put.

    Three policy populations share one market (the first mixed-policy
    scenario): chasers and stickies both run :class:`PriceChasingPolicy` —
    the relocation-cost friction term alone splits them into movers and
    premium payers — and the background fleet in the cold clusters splits
    between :class:`StaticPolicy` and :class:`BudgetSmoothingPolicy`.
    Agent names carry the group (``chaser-*`` / ``sticky-*`` / ``bg-*``) so
    tests and reports can track each population's fate.
    """
    rng = np.random.default_rng(seed)
    C = 4
    base_cost = np.asarray(FLEET_BASE_COST)
    n_chase, n_sticky, n_bg = 120, 60, 60
    n = n_chase + n_sticky + n_bg
    group = np.repeat(np.arange(3), [n_chase, n_sticky, n_bg])

    chips = rng.choice(np.asarray([16.0, 32.0, 64.0]), size=n)
    req = np.stack([chips, chips * 12.0, chips * 100.0], axis=1)
    cost = req @ base_cost
    hot = group < 2  # chasers + stickies are homed (and placed) in cluster 0
    home = np.where(hot, 0, rng.integers(1, C, n))
    placed = np.where(
        hot, home, np.where(rng.random(n) < 0.5, home, -1)
    )
    value = cost * np.select([group == 0, group == 1], [2.5, 5.0], 1.6)
    reloc = cost * np.select([group == 0, group == 1], [0.03, 5.0], 0.5)
    arbitrage = np.select([group == 0, group == 1], [0.02, 0.25], 0.0)
    # chasers AND stickies run PriceChasing (id 1) — friction does the
    # splitting; background alternates Static (0) / BudgetSmoothing (2)
    policy = np.where(hot, 1, np.where(np.arange(n) % 2 == 0, 0, 2))
    tags = ("chaser", "sticky", "bg")
    pop = AgentPopulation(
        req=req, value=value, home=home, relocation_cost=reloc,
        mobility=np.full(n, 1.0), margin0=np.full(n, 1.0),
        margin_decay=np.full(n, 0.30), arbitrage=arbitrage,
        budget=np.full(n, np.inf), placed=placed,
        epoch=np.zeros(n, np.int64), policy=policy,
        names=[f"{tags[g]}-{i}" for i, g in enumerate(group)],
    )

    # cluster 0 sized so its pre-loaded utilization is exactly 0.93 — well
    # over the reserve target (φ_exp(0.93) ≈ 3.4× base cost) and over the
    # trader gate at 0.75; each cold cluster alone could absorb the fleet
    capacity = np.zeros((C, 3))
    capacity[0] = req[hot].sum(axis=0) / 0.93
    for c in range(1, C):
        capacity[c] = req.sum(axis=0) * rng.uniform(0.8, 1.2)
    eco = Economy(
        clusters=[f"cluster-{c}" for c in range(C)],
        rtypes=list(FLEET_RTYPES),
        capacity=capacity,
        base_cost=base_cost,
        agents=pop,
        seed=seed + 1,
        policies=[
            StaticPolicy(),
            PriceChasingPolicy(sell_prob=0.10),
            BudgetSmoothingPolicy(),
        ],
        device=device,
        **eco_kwargs,
    )
    return eco, Scenario(
        "migration_relief", epochs=epochs,
        description=(
            "price chasers drain a 93%-hot pool; sticky agents pay the "
            "premium to stay"
        ),
    )


def region_loss(seed: int = 3, epochs: int = 6, *, device="cuda", **eco_kwargs):
    """Fault injection: cluster-0 goes dark at epoch 1 and never comes back.

    Unlike :func:`cluster_drain` (an operator decommission that rewrites
    nominal capacity), this is a *fault*: nominal capacity is untouched,
    the :class:`~repro_torch.core.faults.FaultModel` scales the effective
    capacity each epoch sees, holders are clawed back with compensation,
    and every epoch from the loss onward reports ``degraded=True``."""
    eco = make_fleet_economy(
        seed=seed,
        faults=FaultModel(
            region_faults=(RegionFault(cluster=0, start=1, scale=0.0),),
        ),
        clock_retries=2,
        ration_fallback=True,
        device=device,
        **eco_kwargs,
    )
    return eco, Scenario(
        "region_loss", epochs=epochs,
        description="cluster-0 region loss at epoch 1, no recovery",
    )


def region_recovery(seed: int = 3, epochs: int = 6, *, device="cuda", **eco_kwargs):
    """Fault injection: cluster-0 degrades to 25% capacity for two epochs,
    then recovers exactly — nominal capacity was never touched, so the
    post-recovery market is the pre-fault market plus re-placement churn."""
    eco = make_fleet_economy(
        seed=seed,
        faults=FaultModel(
            region_faults=(
                RegionFault(cluster=0, start=1, end=3, scale=0.25),
            ),
        ),
        clock_retries=2,
        ration_fallback=True,
        device=device,
        **eco_kwargs,
    )
    return eco, Scenario(
        "region_recovery", epochs=epochs,
        description="cluster-0 at 25% capacity for epochs 1-2, then back",
    )


def unreliable_supply(seed: int = 3, epochs: int = 6, *, device="cuda", **eco_kwargs):
    """Fault injection: Tycoon-style flaky participants — bidders drop out,
    winning sellers flake on delivery, pools fail right after settlement.
    The reliability EMA decays on failing pools and the reputation-weighted
    reserve prices their supply up, shifting demand toward pools that
    actually deliver."""
    eco = make_fleet_economy(
        seed=seed,
        faults=FaultModel(
            seed=seed + 7,
            bid_dropout=0.10,
            seller_fail=0.25,
            pool_fail=0.15,
            pool_fail_scale=0.5,
        ),
        clock_retries=2,
        ration_fallback=True,
        device=device,
        **eco_kwargs,
    )
    return eco, Scenario(
        "unreliable_supply", epochs=epochs,
        description="10% bid dropout, 25% seller flake, 15% pool failure",
    )


SCENARIOS: dict[str, Callable] = {
    "congestion_relief": congestion_relief,
    "cluster_drain": cluster_drain,
    "price_shock": price_shock,
    "flash_crowd": flash_crowd,
    "sticky_relocation": sticky_relocation,
    "migration_relief": migration_relief,
    "region_loss": region_loss,
    "region_recovery": region_recovery,
    "unreliable_supply": unreliable_supply,
}
