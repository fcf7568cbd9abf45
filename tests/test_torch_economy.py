"""The port's §V economy against a live JAX economy, epoch for epoch, on the CPU.

Contract: prices, reserves, utilization, rounds, migrations, convergence,
SYSTEM feasibility and every count are bit-identical; fields derived from
payments (premiums, surplus, value of trade, compensation) agree to rtol
1e-5, since the port's payment fold is not XLA's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import repro.core as jx  # noqa: E402
from repro.core.faults import FaultModel as JFaultModel, RegionFault as JRegionFault  # noqa: E402
from repro_torch import core as pt  # noqa: E402
from repro_torch.core.faults import FaultModel, RegionFault  # noqa: E402

EXACT_ARRAYS = (
    "prices", "reserve", "psi", "price_ratio", "buy_util_percentiles", "sell_util_percentiles",
)
EXACT_SCALARS = (
    "epoch", "rounds", "migrations", "converged", "system_ok", "pct_settled", "warm_started",
    "degraded", "clock_escalations", "rationed_rows", "dropped_bids", "seller_failures",
    "failed_pools", "evictions", "clawback_units", "arrivals_rejected",
)
PAYMENT_FIELDS = ("gamma_median", "gamma_mean", "surplus", "value_of_trade", "compensation")


def _assert_stats_agree(sj, st, where):
    for f in EXACT_ARRAYS:
        a, b = getattr(sj, f), getattr(st, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, f, a, b)
    for f in EXACT_SCALARS:
        assert getattr(sj, f) == getattr(st, f), (where, f, getattr(sj, f), getattr(st, f))
    for f in PAYMENT_FIELDS:
        np.testing.assert_allclose(getattr(st, f), getattr(sj, f), rtol=1e-5, err_msg=f"{where} {f}")


def _assert_state_agrees(ej, et):
    for f in ("placed", "home", "fill_rate", "epoch"):
        np.testing.assert_array_equal(getattr(ej.pop, f), getattr(et.pop, f), err_msg=f)
    np.testing.assert_array_equal(ej.usage, et.usage)
    np.testing.assert_array_equal(ej.belief, et.belief)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_fleet_epochs_match_jax(seed, warm):
    ej = jx.make_fleet_economy(seed=seed, warm_start=warm)
    et = pt.make_fleet_economy(seed=seed, warm_start=warm, device="cpu")
    for epoch in range(3):
        _assert_stats_agree(ej.run_epoch(), et.run_epoch(), (seed, warm, epoch))
    _assert_state_agrees(ej, et)


def test_fault_epochs_match_jax():
    def faults(fm, rf):
        return fm(seed=2, bid_dropout=0.15, seller_fail=0.2, pool_fail=0.1,
                  region_faults=(rf(cluster=2, start=1, end=3, scale=0.25),))

    kw = dict(seed=0, clock_retries=1, ration_fallback=True)
    ej = jx.make_fleet_economy(faults=faults(JFaultModel, JRegionFault), **kw)
    et = pt.make_fleet_economy(faults=faults(FaultModel, RegionFault), device="cpu", **kw)
    for epoch in range(4):
        _assert_stats_agree(ej.run_epoch(), et.run_epoch(), epoch)
    _assert_state_agrees(ej, et)
    np.testing.assert_array_equal(ej.pool_reliability, et.pool_reliability)


def test_policy_mix_epochs_match_jax():
    def build(mod, **kw):
        mix = [mod.StaticPolicy(), mod.PriceChasingPolicy(), mod.BudgetSmoothingPolicy()]
        eco = mod.make_fleet_economy(seed=3, policies=mix, warm_start=True, **kw)
        eco.pop.policy[:] = np.arange(len(eco.pop)) % 3
        return eco

    ej, et = build(jx), build(pt, device="cpu")
    for epoch in range(3):
        _assert_stats_agree(ej.run_epoch(), et.run_epoch(), epoch)
    _assert_state_agrees(ej, et)


def test_state_carries_from_jax_to_port():
    """One JAX epoch → its state tree → a port economy: both settle the next
    two epochs identically."""
    ej = jx.make_fleet_economy(seed=7, warm_start=True)
    ej.run_epoch()
    tree, rng_state = pt.economy_state(ej)
    et = pt.make_fleet_economy(seed=7, warm_start=True, device="cpu")
    pt.load_economy_state(et, tree, rng_state)
    back, _ = pt.economy_state(et)
    assert sorted(back) == sorted(tree)
    for epoch in range(2):
        _assert_stats_agree(ej.run_epoch(), et.run_epoch(), epoch)
    _assert_state_agrees(ej, et)


def test_dry_run_is_side_effect_free_and_matches_jax():
    ej = jx.make_fleet_economy(seed=0)
    et = pt.make_fleet_economy(seed=0, device="cpu")
    pj, pp = ej.preview_prices(), et.preview_prices()
    np.testing.assert_array_equal(pj, pp)
    assert not et.price_history
    sj, st = ej.run_epoch(), et.run_epoch()
    _assert_stats_agree(sj, st, "binding")
    np.testing.assert_array_equal(st.prices, pp)


def test_vectorized_fleet_economy_matches_jax():
    """The array-built fleet (markets.fleet_economy) at a size whose user
    blocks take XLA's windowed fold (m > 32 rows per block)."""
    ej = jx.fleet_economy(1500, 6, seed=1)
    et = pt.fleet_economy(1500, 6, seed=1, device="cpu")
    for epoch in range(2):
        _assert_stats_agree(ej.run_epoch(), et.run_epoch(), epoch)
    _assert_state_agrees(ej, et)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_fleet_economy_warm_and_cold_restarts_match_jax(warm):
    """``chip_smoke.py``'s economy, fleet_economy(N, 8, seed=0), at 5,000
    agents: a cold restart re-seeds every clock from the reserve curve, a warm
    start from max(p_prev, reserve), and the port's rounds, prices and
    placements follow the reference's under both."""
    ej = jx.fleet_economy(5_000, 8, seed=0, warm_start=warm)
    et = pt.fleet_economy(5_000, 8, seed=0, warm_start=warm, device="cpu")
    for epoch in range(3):
        _assert_stats_agree(ej.run_epoch(), et.run_epoch(), (warm, epoch))
    _assert_state_agrees(ej, et)


def test_churn_matches_jax():
    ej = jx.make_fleet_economy(seed=3)
    et = pt.make_fleet_economy(seed=3, device="cpu")
    _assert_stats_agree(ej.run_epoch(), et.run_epoch(), 0)
    gone = np.arange(len(ej.pop)) % 5 == 0
    assert ej.remove_agents(gone) == et.remove_agents(gone)
    arrivals_j = jx.fleet_population(12, 6, seed=9)
    arrivals_t = pt.fleet_population(12, 6, seed=9)
    assert ej.add_agents(arrivals_j) == et.add_agents(arrivals_t)
    _assert_stats_agree(ej.run_epoch(), et.run_epoch(), 1)
    _assert_state_agrees(ej, et)


def test_fused_epoch_and_loop_packer_construct():
    assert pt.make_fleet_economy(seed=0, device="cpu", fused=True).fused
    assert pt.make_fleet_economy(seed=0, device="cpu", packer="loop").packer == "loop"


def test_service_bridge_matches_reference():
    """The service bridge exports and drains exactly the reference's rows,
    also after removals and an epoch; a second drain is empty."""
    ej, et = jx.make_fleet_economy(seed=0), pt.make_fleet_economy(seed=0, device="cpu")

    def same_rows(a, b):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and np.array_equal(x, y)

    same_rows(ej.export_bid_rows(), et.export_bid_rows())
    for eco in (ej, et):
        eco.remove_agents(np.arange(len(eco.pop)) % 5 == 0)
        eco.run_epoch()
    wj, uj = ej.drain_bid_deltas()
    wt, ut = et.drain_bid_deltas()
    assert wj == wt and len(wt) > 0
    same_rows(uj, ut)
    assert et.drain_bid_deltas()[0] == []
