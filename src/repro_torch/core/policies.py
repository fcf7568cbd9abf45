"""Vectorized bidder policies — the economy's adaptive-behavior layer.

The paper's headline result is behavioral, not mechanical: under
utilization-based reserve prices users *migrate* from congested pools to
under-utilized ones, while users with high reconfiguration costs pay large
price premiums to stay put.  Tycoon (Lai et al.) frames the same
requirement from the other side — market feedback only matters if agents
adapt their bids to it.  A :class:`BidderPolicy` is that adaptation loop:
each epoch it observes the struct-of-arrays :class:`~.economy
.AgentPopulation` fields plus the previous epoch's market outcome
(:class:`Observation`: settled prices, reserve curve, utilization,
per-agent fill rates) and emits a pure-array :class:`PolicyAction` over
the agents it controls.  No per-agent Python runs anywhere on this path,
so a 10⁵-agent policy step is a handful of (N, C) array ops.

The action surface is deliberately a per-epoch *overlay*, not a state
mutation: reach-key bias, sticky-vs-redrawn reach sets, π scaling, and a
sell-intent (arbitrage) override are consumed by the epoch packer and then
discarded.  That buys three properties for free:

* ``StaticPolicy`` (the parity oracle) is bit-identical to a policy-less
  economy by construction — it emits no action, so the packer sees exactly
  the arrays it sees today;
* ``Economy.preview_prices`` stays side-effect-free even with policies
  attached, because ``act`` must be pure and overlays are never persisted
  on a dry run;
* populations can mix policies per agent (``AgentPopulation.policy`` ids
  index the economy's policy list) without any coordination between them.

Reach semantics: the epoch packer turns ``perm_keys`` (one uniform sort
key per agent × cluster) into each agent's cluster-reach permutation via a
stable argsort, truncated to its mobility budget, home first.  Policies
therefore steer *reach membership* — which clusters an agent's XOR bundle
set covers — by adding bias to those keys (lower key = more preferred) and
by choosing whether an agent re-draws its keys this epoch (dynamic reach)
or keeps last epoch's (sticky reach).  Which bundle *wins* stays entirely
the auction's choice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Observation:
    """What a policy may condition on: last epoch's market, this epoch's
    pre-auction state.  All arrays are defensive copies — policies can
    scribble on them freely without touching economy state."""

    epoch: int  # index of the epoch about to be settled
    prices: np.ndarray | None  # (R,) previous settled prices (None at epoch 0)
    reserve: np.ndarray | None  # (R,) previous reserve curve (None at epoch 0)
    psi: np.ndarray  # (R,) current pre-auction utilization, flat pools
    belief: np.ndarray  # (R,) the economy's shared price belief
    fill_rate: np.ndarray  # (N,) EMA of each agent's buy-bid fills
    num_clusters: int
    num_rtypes: int


@dataclasses.dataclass
class PolicyAction:
    """One epoch's pure-array bid-parameter overlay.

    Every field is optional (None = leave that parameter alone) and is
    indexed over the policy's agent subset — row i of an action array
    belongs to agent ``idx[i]`` of the ``act`` call.
    """

    # added to the reach sort keys before the packer's argsort; more
    # negative = more preferred, −(1+ε) beats every unbiased U(0,1) key
    reach_bias: np.ndarray | None = None  # (n, C) float
    # True → draw a fresh reach permutation this epoch (today's behavior);
    # False → keep the agent's stored keys (sticky reach set).  None = all
    # fresh.  Agents with no stored keys yet always use the fresh draw.
    redraw_reach: np.ndarray | None = None  # (n,) bool
    # multiplies the buy-bid π cap min(value−reloc, believed·(1+margin),
    # budget); applied in float64 before the book's float32 cast
    pi_scale: np.ndarray | None = None  # (n,) float
    # this-epoch override of the arbitrage (sell-intent) probability the
    # packer's trader gate reads; the population's own field is untouched
    arbitrage: np.ndarray | None = None  # (n,) float
    # this-epoch override of the bid margin the π cap believed·(1+margin)
    # uses; a large value makes the agent bid its raw value (chasers trust
    # the price signal instead of shading toward belief)
    margin: np.ndarray | None = None  # (n,) float


class BidderPolicy:
    """Interface: observe the market, emit a :class:`PolicyAction`.

    ``act`` MUST be pure — no mutation of ``pop`` arrays, no internal
    state that an action depends on (work arrays reused from call to call
    are fine; no returned array may be one).  The economy calls it on dry
    runs (``preview_prices``) too, and purity is what keeps those
    side-effect-free.  Persistent per-agent
    policy state belongs in ``AgentPopulation`` fields (e.g. ``fill_rate``),
    which the economy maintains through arrivals and departures.
    """

    name = "base"

    def act(
        self, obs: Observation, pop, idx: np.ndarray
    ) -> PolicyAction | None:
        """Return this epoch's overlay for agents ``idx`` (None = no-op)."""
        raise NotImplementedError


class StaticPolicy(BidderPolicy):
    """Bid exactly as the packer always has — the parity oracle.

    Emits no action, so an economy running ``StaticPolicy`` for every agent
    is bit-identical (bid book, EpochStats, mutable state) to one with no
    policy subsystem at all; the parity suite pins that equivalence.
    """

    name = "static"

    def act(self, obs, pop, idx):
        return None


@dataclasses.dataclass
class PriceChasingPolicy(BidderPolicy):
    """Migrate toward pools priced below belief; stay put under friction.

    The paper's congestion→relief transition, as bidder behavior: an agent
    whose last-epoch prices reveal a cluster cheap enough to clear its
    relocation cost *chases* — it re-draws its reach (a dynamic per-epoch
    re-draw, policy-triggered), biases the draw toward every cluster priced
    below its belief, and raises its sell intent so held resources in the
    expensive home go back on the market.  An agent whose relocation cost
    eats the saving stays home, keeps its sticky reach set, and — when its
    own churn puts it through the market — re-buys its home pool at the
    congestion premium: the paper's "some users pay large premiums to
    avoid reconfiguration" population, produced by the friction term
    rather than a separate agent class.

    Invariant (property-tested): ``reach_bias`` is never negative on a
    cluster priced *above* belief — weight only ever moves toward
    below-belief clusters.
    """

    strength: float = 2.0  # key bias per unit of fractional cheapness
    friction: float = 1.0  # relocation-cost multiplier in the chase gate
    sell_prob: float = 0.35  # sell intent of placed chasers, per epoch
    sticky_reach: bool = True  # non-chasers keep their reach set
    chase_margin: float = 50.0  # margin override while chasing (≈ bid value)

    name = "price_chasing"

    # work arrays kept from one ``act`` to the next, grown to the largest
    # agent count seen: at 10⁵ agents the step's (n, C) temporaries are tens
    # of MB, and allocating them afresh every epoch costs fresh pages
    _scratch: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def _buffers(self, n: int, C: int, T: int) -> dict[str, np.ndarray]:
        """Scratch views over the first ``n`` rows: ``req`` (n, T), ``costs``
        (n, 2C), ``cheap`` and ``work`` (n, C) float64, ``mask`` (n, C) bool.
        No action holds one: every array ``act`` returns is made afresh."""
        shapes = {"req": (T, np.float64), "costs": (2 * C, np.float64),
                  "cheap": (C, np.float64), "work": (C, np.float64),
                  "mask": (C, np.bool_)}
        buf = self._scratch
        if any(buf.get(k) is None or buf[k].shape[0] < n or buf[k].shape[1] != w
               for k, (w, _) in shapes.items()):
            buf.update({k: np.empty((n, w), dt) for k, (w, dt) in shapes.items()})
        return {k: v[:n] for k, v in buf.items()}

    def act(self, obs, pop, idx):
        if obs.prices is None:
            return None  # epoch 0: no market signal yet
        n, C, T = idx.size, obs.num_clusters, obs.num_rtypes
        buf = self._buffers(n, C, T)
        req = np.take(pop.req, idx, axis=0, out=buf["req"])
        # Both cost matrices in one BLAS call: req (n, T) against the price
        # and belief curves stacked as (T, 2C).  Decision logic, not
        # settlement — it does not need bundle_cluster_costs' fixed fold
        # order, and at 10⁵ agents the fused dgemm is what keeps the policy
        # step a small fraction of the epoch pack.
        curves = np.concatenate(
            [
                np.asarray(obs.prices, np.float64).reshape(C, T),
                np.asarray(obs.belief, np.float64).reshape(C, T),
            ],
            axis=0,
        ).T  # (T, 2C)
        costs = np.matmul(req, curves, out=buf["costs"])
        cost_prev, cost_bel = costs[:, :C], costs[:, C:]  # (n, C) each
        # > 0: cluster priced below belief
        cheap = np.subtract(cost_bel, cost_prev, out=buf["cheap"])

        # chase gate: the best realizable move must clear the relocation
        # friction.  Homed agents compare against their home's price cost;
        # homeless agents buy regardless, so any below-belief cluster that
        # clears the friction term is worth chasing.
        home = pop.home[idx]
        reloc = self.friction * pop.relocation_cost[idx]
        ar = np.arange(n)
        home_cl = np.clip(home, 0, C - 1)
        work, mask = buf["work"], buf["mask"]
        move_gain = np.subtract(cost_prev[ar, home_cl][:, None], cost_prev, out=work)
        move_gain -= reloc[:, None]
        move_gain[ar, home_cl] = -np.inf  # staying home is not a move
        moves = np.greater(move_gain, 0.0, out=mask).any(axis=1)
        buys = np.greater(np.subtract(cheap, reloc[:, None], out=work), 0.0,
                          out=mask).any(axis=1)
        chase = np.where(home >= 0, moves, buys)

        # bias: fractional cheapness, only on below-belief clusters, only
        # for chasers.  strength ≥ 2 guarantees a fully-cheap cluster sorts
        # ahead of every unbiased U(0,1) key.
        rel = np.maximum(np.abs(cost_bel, out=work), 1e-9, out=work)
        rel = np.divide(cheap, rel, out=work)
        scaled = np.multiply(-self.strength, np.clip(rel, 0.0, 1.0, out=work), out=work)
        np.greater(cheap, 0.0, out=mask)
        mask &= chase[:, None]
        bias = np.where(mask, scaled, 0.0)

        # placed chasers put their holdings on the market (the packer's
        # trader gate still requires a congested home, psi > 0.75)
        arb = None
        sellers = chase & (pop.placed[idx] >= 0)
        if sellers.any():
            arb = np.where(
                sellers,
                np.maximum(pop.arbitrage[idx], self.sell_prob),
                pop.arbitrage[idx],
            )

        # chasers trust the price signal: lift the believed·(1+margin) cap
        # out of the way so their π is raw value − relocation.  The decayed
        # margin otherwise pins late-epoch bids to ~believed everywhere,
        # and since belief tracks settled prices, the expensive home's
        # larger absolute cushion would win every re-buy (no migration).
        margin = None
        if chase.any():
            margin = np.where(chase, self.chase_margin, pop.margins()[idx])

        redraw = chase | (not self.sticky_reach)
        return PolicyAction(
            reach_bias=bias, redraw_reach=redraw, arbitrage=arb, margin=margin
        )


@dataclasses.dataclass
class BudgetSmoothingPolicy(BidderPolicy):
    """Scale π by realized fill rate — bid caution from market feedback.

    An agent whose buy bids keep winning bids its full cap; one that keeps
    losing shades its cap toward ``floor`` of it, smoothing spend across
    epochs instead of repeatedly bidding (and briefly over-paying for)
    bundles the market is not clearing for it.  ``fill_rate`` is the
    economy-maintained per-agent EMA of buy fills, so the scale is pure
    feedback — no agent state lives in the policy.
    """

    floor: float = 0.5  # π scale at a zero fill rate

    name = "budget_smoothing"

    def act(self, obs, pop, idx):
        fr = np.clip(obs.fill_rate[idx], 0.0, 1.0)
        return PolicyAction(pi_scale=self.floor + (1.0 - self.floor) * fr)


#: name → zero-argument constructor for every shipped policy
POLICY_REGISTRY = {
    "static": StaticPolicy,
    "price_chasing": PriceChasingPolicy,
    "budget_smoothing": BudgetSmoothingPolicy,
}
