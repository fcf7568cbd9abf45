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

# elements of an (n, C) work array that ``PriceChasingPolicy`` passes over
# at a time: a block's operands stay in the core's cache
_BLOCK = 1 << 15


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


def reduce_rows(ufunc, a: np.ndarray) -> np.ndarray:
    """(n,) ``ufunc`` folded along each row of the C-contiguous (n, C) ``a``.

    ``ufunc.reduce(a, axis=1)`` runs one inner loop per row, which at C = 8
    costs more than the arithmetic; here each pass folds adjacent column
    pairs of every row at once, while the width is even, then the odd
    columns left one by one.  For an order-free ``ufunc`` (``fmin``,
    ``fmax``, ``bitwise_or``) the result is the row-wise reduction's.  ``a``
    is not written."""
    n, w = a.shape
    while w > 1 and w % 2 == 0:
        pairs = a.reshape(n * (w // 2), 2)
        a = ufunc(pairs[:, 0], pairs[:, 1]).reshape(n, w // 2)
        w //= 2
    out = a[:, 0].copy()
    for c in range(1, w):
        ufunc(out, a[:, c], out=out)
    return out


def rows_any(mask: np.ndarray) -> np.ndarray:
    """(n,) whether each row of the C-contiguous (n, C) bool ``mask`` holds
    a True: its bytes read as the widest unsigned words that tile a row
    (one word a row at C = 8), OR-ed by :func:`reduce_rows`."""
    width = next(w for w in (8, 4, 2, 1) if mask.shape[1] % w == 0)
    return reduce_rows(np.bitwise_or, mask.view(f"u{width}")) != 0


def row_items(a: np.ndarray) -> np.ndarray:
    """The rows of the C-contiguous 2-D ``a`` as an (n,) view of opaque
    items, one row each: numpy gathers, scatters and selects such an item
    in one step, where on the 2-D array it runs an inner loop per row."""
    return a.view(np.dtype((np.void, a.shape[1] * a.itemsize))).reshape(a.shape[0])


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
    # agent count seen: at 10⁵ agents the step's temporaries are tens of MB,
    # and allocating them afresh every epoch costs fresh pages
    _scratch: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def _buffers(self, n: int, C: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Scratch views: ``costs`` (n, 2C) float64 over all ``n`` rows, and
        over one block of rows ``halves`` (2, rows, C) float64 and ``mask``
        (rows, C) bool.  No action holds one: every array ``act`` returns
        is made afresh."""
        rows = max(1, min(n, _BLOCK // C))
        buf = self._scratch
        if buf.get("C") != C or len(buf["costs"]) < n or len(buf["mask"]) < rows:
            buf.update(C=C, costs=np.empty((n, 2 * C)), halves=np.empty((2, rows, C)),
                       mask=np.empty((rows, C), bool))
        return buf["costs"][:n], buf["halves"][:, :rows], buf["mask"][:rows]

    def act(self, obs, pop, idx):
        if obs.prices is None:
            return None  # epoch 0: no market signal yet
        n, C, T = idx.size, obs.num_clusters, obs.num_rtypes
        costs, halves, mask = self._buffers(n, C)
        req = np.take(pop.req, idx, axis=0)
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
        np.matmul(req, curves, out=costs)
        home = pop.home[idx]
        reloc = self.friction * pop.relocation_cost[idx]
        chase = np.empty(n, bool)
        bias = np.zeros((n, C))
        # a block of rows at a time, so that every pass reads its operands
        # from cache rather than from memory
        rows = len(mask)
        for lo in range(0, n, rows):
            hi = min(lo + rows, n)
            self._chase_rows(costs[lo:hi], home[lo:hi], reloc[lo:hi],
                             chase[lo:hi], bias[lo:hi], halves, mask)

        # placed chasers put their holdings on the market (the packer's
        # trader gate still requires a congested home, psi > 0.75)
        arb = None
        sellers = chase & (pop.placed[idx] >= 0)
        if sellers.any():
            own = pop.arbitrage[idx]
            arb = np.where(sellers, np.maximum(own, self.sell_prob), own)

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

    def _chase_rows(self, costs, home, reloc, chase, bias, halves, mask):
        """The chase gate and the reach bias of one block of rows, written
        into ``chase`` (b,) and ``bias`` (b, C), from its ``costs`` (b, 2C);
        ``halves`` and ``mask`` are scratch of at least b rows."""
        b, C = bias.shape
        halves, mask = halves[:, :b], mask[:b]
        # the two halves copied apart, each contiguous: on a (b, C) half of
        # ``costs`` numpy's passes run one inner loop per row
        np.copyto(halves, costs.reshape(b, 2, C).transpose(1, 0, 2))
        cost_prev, cost_bel = halves

        # chase gate: the best realizable move must clear the relocation
        # friction.  Homed agents compare against their home's price cost;
        # homeless agents buy regardless, so any below-belief cluster that
        # clears the friction term is worth chasing.  Subtraction is
        # monotone, so some cluster c has cost_home − cost_c − reloc > 0 iff
        # the cheapest c does, and some has cheap_c − reloc > 0 iff the
        # cheapest against belief does; fmin and fmax skip NaN as > 0.0
        # does.  The home's own cost is NaN while the cheapest is found,
        # since staying home is not a move: with C = 1 no cluster is left,
        # and no agent moves.
        home_at = np.arange(0, b * C, C) + np.clip(home, 0, C - 1)
        flat_prev = cost_prev.reshape(-1)
        cost_home = flat_prev[home_at]
        flat_prev[home_at] = np.nan
        gain = reduce_rows(np.fmin, cost_prev)
        gain = np.subtract(cost_home, gain, out=gain)
        np.greater(np.subtract(gain, reloc, out=gain), 0.0, out=chase)
        flat_prev[home_at] = cost_home
        # > 0: cluster priced below belief; over the price half, in place
        cheap = np.subtract(cost_bel, cost_prev, out=cost_prev)
        homeless = home < 0
        if homeless.any():
            buys = reduce_rows(np.fmax, cheap) - reloc > 0.0
            np.copyto(chase, buys, where=homeless)

        # bias: fractional cheapness, only on below-belief clusters, only
        # for chasers; 0.0 elsewhere.  strength ≥ 2 guarantees a
        # fully-cheap cluster sorts ahead of every unbiased U(0,1) key.
        np.greater(cheap, 0.0, out=mask)
        mask &= np.repeat(chase, C).reshape(b, C)
        at = np.flatnonzero(mask)
        rel = cheap.reshape(-1)[at] / np.maximum(np.abs(cost_bel.reshape(-1)[at]), 1e-9)
        bias.reshape(-1)[at] = -self.strength * np.clip(rel, 0.0, 1.0)


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
