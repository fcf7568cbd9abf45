"""Synthetic market builders shared by the tests and ``chip_smoke.py``.

Counterpart of ``repro.core.markets``: the same generators drawing the same
numpy streams, so a seed gives the reference's market exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .auction import ClockConfig
from .economy import FLEET_DISTRIBUTION, AgentPopulation, Economy
from .types import SparseAuctionProblem, pack_bids_sparse

FLEET_RTYPES = ("tpu_chips", "hbm_gb", "ici_gbps")
FLEET_BASE_COST = (10.0, 0.05, 0.2)


def random_market(
    num_bidders: int,
    num_resources: int,
    *,
    bundles_per_bidder: int = 3,
    nnz: int = 2,
    supply: tuple[float, float] = (20.0, 50.0),
    ask_frac: tuple[float, float] = (0.5, 1.0),
    pi: tuple[float, float] = (1.0, 20.0),
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> SparseAuctionProblem:
    """A contested buy/sell market packed into sparse form on ``device``.

    Buyers submit ``bundles_per_bidder`` XOR alternatives of ``nnz`` random
    pools (quantities U(0.5, 4), willingness-to-pay U(*pi*)); every pool gets
    one operator seller offering U(*supply*) units at a minimum revenue of
    ``ask · supply``, ask ∈ U(*ask_frac*).
    """
    rng = np.random.default_rng(seed)
    bundle_lists, pis = [], []
    for _ in range(num_bidders):
        alts = []
        for _ in range(bundles_per_bidder):
            ii = np.sort(rng.choice(num_resources, size=nnz, replace=False))
            vv = rng.uniform(0.5, 4, size=nnz).astype(np.float32)
            alts.append((ii.astype(np.int32), vv))
        bundle_lists.append(alts)
        pis.append(float(rng.uniform(*pi)))
    for r in range(num_resources):
        units = float(rng.uniform(*supply))
        bundle_lists.append([(np.array([r], np.int32), np.array([-units], np.float32))])
        pis.append(float(-rng.uniform(*ask_frac) * units))
    return pack_bids_sparse(
        bundle_lists, pis, base_cost=np.ones(num_resources, np.float32), device=device
    )


def fleet_population(
    num_agents: int,
    num_clusters: int,
    *,
    seed: int = 0,
    congested_frac: float = 0.4,
    base_cost: tuple = FLEET_BASE_COST,
    value_mult: float = 1.0,
    home: int | None = None,
    placed_frac: float | None = None,  # None → the shared fleet default
    policy: int | np.ndarray = 0,
) -> AgentPopulation:
    """Fleet agents drawn as whole arrays (``make_fleet_economy``'s
    distribution): jobs sized in chips with HBM and ICI ∝ chips, homes skewed
    70/30 toward the congested clusters unless ``home`` is fixed."""
    d = FLEET_DISTRIBUTION
    if placed_frac is None:
        placed_frac = d.placed_frac
    rng = np.random.default_rng(seed)
    n = int(num_agents)
    chips = rng.choice(np.asarray(d.chip_sizes), size=n)
    req = np.stack(
        [
            chips,
            chips * rng.uniform(*d.hbm_per_chip, n),
            chips * rng.uniform(*d.ici_per_chip, n),
        ],
        axis=1,
    )
    cost_est = req @ np.asarray(base_cost, np.float64)
    n_congested = max(int(round(congested_frac * num_clusters)), 1)
    if home is None:
        home_arr = np.where(
            rng.random(n) < d.congested_home_frac,
            rng.integers(0, n_congested, n),
            rng.integers(0, num_clusters, n),
        )
    else:
        home_arr = np.full(n, int(home), np.int64)
    placed = np.where(rng.random(n) < placed_frac, home_arr, -1)
    return AgentPopulation(
        req=req,
        value=cost_est * rng.uniform(*d.value_mult, n) * value_mult,
        home=home_arr,
        relocation_cost=cost_est * rng.uniform(*d.relocation_mult, n),
        mobility=rng.uniform(*d.mobility, n),
        margin0=rng.uniform(*d.margin0, n),
        margin_decay=np.full(n, 0.30),
        arbitrage=rng.uniform(*d.arbitrage, n),
        budget=np.full(n, np.inf),
        placed=placed,
        epoch=np.zeros(n, np.int64),
        policy=np.broadcast_to(np.asarray(policy, np.int64), (n,)).copy(),
    )


def fleet_economy(
    num_agents: int = 10_000,
    num_clusters: int = 8,
    *,
    seed: int = 0,
    congested_frac: float = 0.4,
    headroom: float = 1.3,
    clock: ClockConfig = ClockConfig(),
    policy: int | np.ndarray = 0,
    **economy_kwargs,
) -> Economy:
    """A fleet economy built from arrays, for 10⁴–10⁶ agents: capacity sized
    to aggregate demand times ``headroom``, spread unevenly, the first
    ``congested_frac`` of clusters pre-loaded to 88% utilization."""
    rng = np.random.default_rng(seed)
    pop = fleet_population(
        num_agents, num_clusters, seed=seed, congested_frac=congested_frac, policy=policy,
    )
    chips_c = (
        240.0 * num_agents / num_clusters * headroom * rng.uniform(0.7, 1.5, num_clusters)
    )
    capacity = np.stack([chips_c, chips_c * 16.0, chips_c * 200.0], axis=1)
    eco = Economy(
        clusters=[f"cluster-{c}" for c in range(num_clusters)],
        rtypes=FLEET_RTYPES,
        capacity=capacity,
        base_cost=np.asarray(FLEET_BASE_COST),
        agents=pop,
        clock=clock,
        seed=seed + 1,
        **economy_kwargs,
    )
    n_congested = max(int(round(congested_frac * num_clusters)), 1)
    for c in range(n_congested):
        eco.usage[c] = np.maximum(eco.usage[c], 0.88 * eco.capacity[c])
    return eco
