"""Market-economy provisioning core, in PyTorch (the port of ``repro.core``).

* types: ResourcePool, SparseAuctionProblem / CSRAuctionProblem and their
  packers and converters
* reserve: congestion-weighted reserve curves
* auction: clock_auction, ClockConfig, verify_system, surplus_and_trade
* bidlang, policies, faults: numpy copies of the reference's modules
* economy, markets: the §V multi-epoch economy and its builders
* state: an economy's state as a numpy tree, shared with the reference
"""
from .types import (
    CSRAuctionProblem,
    ResourcePool,
    SparseAuctionProblem,
    SparseAuctionResult,
    as_device,
    bundle_cluster_costs,
    csr_from_padded,
    csr_padded_views,
    csr_problem_from_arrays,
    operator_supply_bids,
    pack_bids_sparse,
    padded_from_csr,
    sparse_problem_from_arrays,
    sparse_supply_scale,
)
from .reserve import (
    CURVE_FAMILIES,
    DEFAULT_WEIGHTING,
    ExpWeighting,
    LogisticWeighting,
    PiecewisePowerWeighting,
    reputation_weighted_reserve,
    reserve_prices,
)
from .auction import (
    ClockConfig,
    blocked_demand_fn,
    clock_auction,
    csr_proxy_demand,
    escalate_clock,
    sparse_bundle_costs,
    sparse_proxy_demand,
    sparse_proxy_demand_blocked,
    surplus_and_trade,
    verify_system,
)
from .bidlang import All, BundleExplosion, OneOf, Res, flatten, flatten_sparse, pool_index
from .economy import Agent, AgentPopulation, Economy, EpochStats, make_fleet_economy
from .markets import fleet_economy, fleet_population, random_market
from .policies import (
    POLICY_REGISTRY,
    BidderPolicy,
    BudgetSmoothingPolicy,
    Observation,
    PolicyAction,
    PriceChasingPolicy,
    StaticPolicy,
)
from .faults import FaultDraw, FaultModel
from .state import economy_state, load_economy_state

__all__ = [
    "CSRAuctionProblem", "ResourcePool", "SparseAuctionProblem", "SparseAuctionResult",
    "as_device", "bundle_cluster_costs", "csr_from_padded", "csr_padded_views",
    "csr_problem_from_arrays", "operator_supply_bids", "pack_bids_sparse", "padded_from_csr",
    "sparse_problem_from_arrays", "sparse_supply_scale",
    "CURVE_FAMILIES", "DEFAULT_WEIGHTING", "ExpWeighting", "LogisticWeighting",
    "PiecewisePowerWeighting", "reputation_weighted_reserve", "reserve_prices",
    "ClockConfig", "blocked_demand_fn", "clock_auction", "csr_proxy_demand", "escalate_clock",
    "sparse_bundle_costs", "sparse_proxy_demand", "sparse_proxy_demand_blocked",
    "surplus_and_trade", "verify_system",
    "All", "BundleExplosion", "OneOf", "Res", "flatten", "flatten_sparse", "pool_index",
    "Agent", "AgentPopulation", "Economy", "EpochStats", "make_fleet_economy",
    "fleet_economy", "fleet_population", "random_market",
    "POLICY_REGISTRY", "BidderPolicy", "BudgetSmoothingPolicy", "Observation", "PolicyAction",
    "PriceChasingPolicy", "StaticPolicy", "FaultDraw", "FaultModel",
    "economy_state", "load_economy_state",
]
