"""Market-economy provisioning core, in PyTorch (the port of ``repro.core``).

* types: ResourcePool, AuctionProblem / SparseAuctionProblem /
  CSRAuctionProblem and their packers and converters; MarketBook, the
  service's persistent book
* reserve: congestion-weighted reserve curves
* auction: clock_auction, ClockConfig, verify_system, surplus_and_trade;
  sharded_clock_auction over a torch.distributed process group (users_mesh)
* bidlang, policies, faults: numpy copies of the reference's modules
* economy, markets: the §V multi-epoch economy and its builders
* fused: the fused epoch program (pack → clock → settle → apply on the
  device, CUDA graphs on the card) behind ``Economy(fused=True)``
* scenarios: event streams (outages, flash crowds, churn, price shocks)
  run over the economy epoch by epoch, and the SCENARIOS library
* state: an economy's state as a numpy tree, shared with the reference
* provisioner: settled allocations → per-job device grants
"""
from .types import (
    AuctionProblem,
    AuctionResult,
    CSRAuctionProblem,
    CSRDemandAux,
    MarketBook,
    ResourcePool,
    SparseAuctionProblem,
    SparseAuctionResult,
    as_device,
    bundle_cluster_costs,
    csr_demand_aux,
    csr_from_padded,
    csr_padded_views,
    csr_problem_from_arrays,
    densify,
    operator_supply_bids,
    pack_bids,
    pack_bids_csr,
    pack_bids_sparse,
    pad_users,
    padded_from_csr,
    sparse_problem_from_arrays,
    sparse_supply_scale,
    sparsify,
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
    ClockLoop,
    UsersMesh,
    blocked_demand_fn,
    bundle_costs,
    clock_auction,
    csr_proxy_demand,
    escalate_clock,
    proxy_demand,
    sharded_clock_auction,
    sparse_bundle_costs,
    sparse_proxy_demand,
    sparse_proxy_demand_blocked,
    sparse_proxy_demand_exact,
    surplus_and_trade,
    users_mesh,
    verify_system,
)
from .bidlang import All, BundleExplosion, OneOf, Res, flatten, flatten_sparse, pool_index
from .economy import Agent, AgentPopulation, Economy, EpochStats, make_fleet_economy
from .fused import (
    DeviceMarketState,
    FusedEpoch,
    build_fused_epoch,
    fused_program_cache_size,
)
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
from .scenarios import (
    SCENARIOS,
    Arrivals,
    BaseCostChange,
    CapacityShock,
    Departures,
    EventReport,
    FlashCrowd,
    RoundStarvedWarning,
    Scenario,
    ScenarioResult,
    WeightingSwap,
    run_scenario,
)
from .state import economy_state, load_economy_state
from .provisioner import DeviceGrant, grant_to_mesh, grants_from_allocation, plan_mesh_shape

__all__ = [
    "AuctionProblem", "AuctionResult", "CSRAuctionProblem", "CSRDemandAux", "MarketBook",
    "ResourcePool", "SparseAuctionProblem", "SparseAuctionResult",
    "as_device", "bundle_cluster_costs", "csr_demand_aux", "csr_from_padded",
    "csr_padded_views", "csr_problem_from_arrays", "densify", "operator_supply_bids",
    "pack_bids", "pack_bids_csr", "pack_bids_sparse", "pad_users", "padded_from_csr", "sparse_problem_from_arrays",
    "sparse_supply_scale", "sparsify",
    "CURVE_FAMILIES", "DEFAULT_WEIGHTING", "ExpWeighting", "LogisticWeighting",
    "PiecewisePowerWeighting", "reputation_weighted_reserve", "reserve_prices",
    "ClockConfig", "ClockLoop", "UsersMesh", "blocked_demand_fn", "bundle_costs", "clock_auction",
    "csr_proxy_demand",
    "escalate_clock", "proxy_demand", "sharded_clock_auction",
    "sparse_bundle_costs", "sparse_proxy_demand", "sparse_proxy_demand_blocked",
    "sparse_proxy_demand_exact", "surplus_and_trade", "users_mesh", "verify_system",
    "All", "BundleExplosion", "OneOf", "Res", "flatten", "flatten_sparse", "pool_index",
    "Agent", "AgentPopulation", "Economy", "EpochStats", "make_fleet_economy",
    "DeviceMarketState", "FusedEpoch", "build_fused_epoch", "fused_program_cache_size",
    "fleet_economy", "fleet_population", "random_market",
    "POLICY_REGISTRY", "BidderPolicy", "BudgetSmoothingPolicy", "Observation", "PolicyAction",
    "PriceChasingPolicy", "StaticPolicy", "FaultDraw", "FaultModel",
    "SCENARIOS", "Arrivals", "BaseCostChange", "CapacityShock", "Departures", "EventReport",
    "FlashCrowd", "RoundStarvedWarning", "Scenario", "ScenarioResult", "WeightingSwap",
    "run_scenario",
    "economy_state", "load_economy_state",
    "DeviceGrant", "grant_to_mesh", "grants_from_allocation", "plan_mesh_shape",
]
