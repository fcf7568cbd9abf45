"""The port's §V economy against a live JAX economy, epoch for epoch, on the CPU.

Contract: prices, reserves, utilization, rounds, migrations, convergence,
SYSTEM feasibility and every count are bit-identical; fields derived from
payments (premiums, surplus, value of trade, compensation) agree to rtol
1e-5, since the port's payment fold is not XLA's.
"""
import dataclasses

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


def _assert_stats_bit_identical(a, b, where):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (where, f.name, x, y)
        else:
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), (where, f.name, x, y)


@pytest.mark.parametrize("fused,epoch0,chase", [
    (True, 0, False), (True, 1_000, False), (True, 1_000, True), (False, 1_000, False),
], ids=["fused-young", "fused-established", "fused-chasing", "staged-established"])
def test_stats_match_plain_margins(fused, epoch0, chase):
    """A young fleet and an established one (decay 0.3, 1,000 epochs bid),
    whose margins() skips every power, settle their epochs bit for bit as
    with the plain ``margin0 · decay^epoch``."""
    kw = {"policies": [pt.PriceChasingPolicy()]} if chase else {}
    ecos = [pt.fleet_economy(1_000, 8, seed=5, fused=fused, device="cpu", **kw) for _ in range(2)]
    for eco in ecos:
        eco.pop.epoch[:] = epoch0
    eco, plain = ecos
    plain.pop.margins = lambda p=plain.pop: p.margin0 * p.margin_decay ** p.epoch
    for e in range(3):
        _assert_stats_bit_identical(eco.run_epoch(), plain.run_epoch(), e)
    if chase:
        assert eco.last_policy_counts["policy_margin_overrides"] > 0


def _fold_oracle(eco, perm_keys, dry_run):
    """The policy fold as it was written before its whole-array form, row
    gathers and all: ``(keys, pi_scale, arbitrage, margin, stored keys,
    counts, marked uids)``, the economy left as it was."""
    pop, stored = eco.pop, eco._reach_keys
    obs = eco.observation()
    base_keys = perm_keys.copy()
    pi_scale = arb = margin = None
    marked = set()
    counts = dict.fromkeys(("policy_acted", "policy_redraws", "policy_sellers",
                            "policy_margin_overrides"), 0)
    for pid, pol in enumerate(eco.policies):
        idx = np.flatnonzero(pop.policy == pid)
        if idx.size == 0:
            continue
        act = pol.act(obs, pop, idx)
        if act is None:
            continue
        marked.update(eco._agent_uid[idx].tolist())
        counts["policy_acted"] += idx.size
        if act.redraw_reach is not None:
            counts["policy_redraws"] += int(np.count_nonzero(act.redraw_reach))
            if stored is not None:
                keep = ~np.asarray(act.redraw_reach, bool)
                keep &= ~np.isnan(stored[idx]).any(axis=1)
                rows = idx[keep]
                perm_keys[rows] = stored[rows]
                base_keys[rows] = stored[rows]
        if act.reach_bias is not None:
            perm_keys[idx] += act.reach_bias
        if act.pi_scale is not None:
            if pi_scale is None:
                pi_scale = np.ones(len(pop), np.float64)
            pi_scale[idx] = act.pi_scale
        if act.arbitrage is not None:
            if arb is None:
                arb = pop.arbitrage.copy()
            counts["policy_sellers"] += int(np.count_nonzero(act.arbitrage > arb[idx]))
            arb[idx] = act.arbitrage
        if act.margin is not None:
            if margin is None:
                margin = pop.margins()
            counts["policy_margin_overrides"] += int(np.count_nonzero(act.margin != margin[idx]))
            margin[idx] = act.margin
    if dry_run:
        base_keys, counts, marked = stored, {}, set()
    return perm_keys, pi_scale, arb, margin, base_keys, counts, marked


class _BroadBias(pt.BidderPolicy):
    """A user's policy: a float32 bias of one column, broadcast over the
    clusters, and no redraw choice (every agent draws fresh)."""

    name = "broad_bias"

    def act(self, obs, pop, idx):
        if obs.prices is None:
            return None
        return pt.PolicyAction(reach_bias=np.full((idx.size, 1), -0.25, np.float32),
                               pi_scale=np.full(idx.size, 0.75))


def _same_bits(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("C", [3, 8])
@pytest.mark.parametrize("case", ["nan_rows", "first_epoch", "no_stored_keys", "dry_run"])
def test_policy_fold_matches_row_gather_fold(case, C):
    """``Economy._apply_policies`` against the fold it replaced, bit for
    bit: effective and stored keys, π scale, sell intent, margin, counts
    and the agents marked for the service bridge.  Static, chasing,
    smoothing and a broadcast-bias policy mixed; stored rows with NaN (an
    arrival's) and fresh keys of -0.0 among them; the first epoch, and one
    with prices but no stored keys."""
    mix = [pt.StaticPolicy(), pt.PriceChasingPolicy(sell_prob=0.2),
           pt.BudgetSmoothingPolicy(), _BroadBias()]
    eco = pt.fleet_economy(2_000, C, seed=C, device="cpu", policies=mix)
    eco.pop.policy[:] = np.random.default_rng(C).integers(0, len(mix), len(eco.pop))
    if case != "first_epoch":
        eco.run_epoch()
        eco.run_epoch()
        assert eco._reach_keys is not None
        eco._reach_keys[::7] = np.nan
        eco._reach_keys[3::11, 0] = np.nan
    if case == "no_stored_keys":  # prices, but nothing stored: every agent draws fresh
        eco._reach_keys = None
    rng = np.random.default_rng(100 + C)
    keys = rng.random((len(eco.pop), C))
    keys[::13] = -0.0
    dry = case == "dry_run"
    stored_before = None if eco._reach_keys is None else eco._reach_keys.copy()
    eco._dirty_uids.clear()
    counts_before = dict(eco.last_policy_counts)
    want = _fold_oracle(eco, keys.copy(), dry)
    got = eco._apply_policies(keys.copy(), dry)
    for name, g, w in zip(("keys", "pi_scale", "arbitrage", "margin"), got, want[:4]):
        assert _same_bits(g, w), (case, C, name)
    if dry:
        assert _same_bits(eco._reach_keys, stored_before)
        assert eco.last_policy_counts == counts_before and not eco._dirty_uids
    else:
        assert _same_bits(eco._reach_keys, want[4])
        assert eco._reach_keys is None or not np.shares_memory(got[0], eco._reach_keys)
        assert eco.last_policy_counts == want[5]
        assert eco._dirty_uids == want[6]
    if case == "nan_rows":
        assert want[5]["policy_redraws"] < want[5]["policy_acted"]
