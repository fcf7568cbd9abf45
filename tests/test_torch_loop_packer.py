"""The port's per-agent loop packer, loop apply and loop clawback, on the CPU.

``Economy(packer="loop")`` packs the bid book agent by agent into the
K-padded encoding and applies the settlement row by row: the parity oracle
of the vectorized packer, as in the reference.  Held here against the
reference's loops (books bit for bit, epochs to the contract of
``tests/test_torch_economy.py``) and against the port's vectorized packer
and apply (bit for bit, mirroring ``tests/test_population_parity.py``), and
``_claw_to_capacity_loop`` against the reference's and the vectorized
clawback (mirroring ``tests/test_claw_parity.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import repro.core as jx  # noqa: E402
from repro.core.economy import _claw_to_capacity_loop as j_claw_loop  # noqa: E402
from repro.core.faults import FaultModel as JFaultModel, RegionFault as JRegionFault  # noqa: E402
from repro_torch import core as pt  # noqa: E402
from repro_torch.core.economy import _claw_to_capacity, _claw_to_capacity_loop  # noqa: E402
from repro_torch.core.faults import FaultModel, RegionFault  # noqa: E402

SEEDS = (0, 3, 7)
EPOCHS = 4
PADDED_FIELDS = ("idx", "val", "bundle_mask", "pi", "base_cost", "supply_scale")
CSR_FIELDS = ("idx", "val", "rows", "offsets", "bundle_mask", "pi", "base_cost", "supply_scale")
BOOK_FIELDS = ("pi_mat", "row_kind", "row_agent", "sell_cluster", "bundle_cluster")
EXACT_ARRAYS = (
    "prices", "reserve", "psi", "price_ratio", "buy_util_percentiles", "sell_util_percentiles",
)
EXACT_SCALARS = (
    "epoch", "rounds", "migrations", "converged", "system_ok", "pct_settled", "warm_started",
    "degraded", "clock_escalations", "rationed_rows", "dropped_bids", "seller_failures",
    "failed_pools", "evictions", "clawback_units", "arrivals_rejected",
)
PAYMENT_FIELDS = ("gamma_median", "gamma_mean", "surplus", "value_of_trade", "compensation")


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_fields_equal(pa, pb, fields, ctx):
    for f in fields:
        va, vb = _host(getattr(pa, f)), _host(getattr(pb, f))
        assert va.dtype == vb.dtype and va.shape == vb.shape, (ctx, f, va.dtype, vb.dtype)
        np.testing.assert_array_equal(va, vb, err_msg=f"{ctx} {f}")


def _preview(eco):
    """The coming epoch's book, with the RNG put back so the binding epoch
    draws the same one."""
    state = eco.rng.bit_generator.state
    book = eco.pack_bid_book()
    eco.rng.bit_generator.state = state
    return book


def _faults(fm, rf):
    return fm(seed=2, bid_dropout=0.15, seller_fail=0.2, pool_fail=0.1,
              region_faults=(rf(cluster=2, start=1, end=3, scale=0.25),))


def _assert_stats_agree(sj, st, where):
    for f in EXACT_ARRAYS:
        a, b = getattr(sj, f), getattr(st, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, f, a, b)
    for f in EXACT_SCALARS:
        assert getattr(sj, f) == getattr(st, f), (where, f, getattr(sj, f), getattr(st, f))
    for f in PAYMENT_FIELDS:
        np.testing.assert_allclose(getattr(st, f), getattr(sj, f), rtol=1e-5, err_msg=f"{where} {f}")


def _stats_bit_identical(sa, sb, ctx):
    da, db = dataclasses.asdict(sa), dataclasses.asdict(sb)
    for k, va in da.items():
        vb = db[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), (ctx, k)
        elif isinstance(va, float) and np.isnan(va):
            assert np.isnan(vb), (ctx, k)
        else:
            assert va == vb, (ctx, k, va, vb)


@pytest.mark.parametrize("seed", SEEDS)
def test_loop_books_match_the_reference_loop_packer(seed):
    """Same randomness, faults and policies → the reference's loop book, bit
    for bit, every epoch; and the epochs settle alike."""
    def build(mod, fm, rf, **kw):
        mix = [mod.StaticPolicy(), mod.PriceChasingPolicy(), mod.BudgetSmoothingPolicy()]
        eco = mod.make_fleet_economy(seed=seed, packer="loop", policies=mix, warm_start=True,
                                     faults=_faults(fm, rf), clock_retries=1,
                                     ration_fallback=True, **kw)
        eco.pop.policy[:] = np.arange(len(eco.pop)) % 3
        return eco

    ej = build(jx, JFaultModel, JRegionFault)
    et = build(pt, FaultModel, RegionFault, device="cpu")
    for epoch in range(EPOCHS):
        bj, bt = _preview(ej), _preview(et)
        _assert_fields_equal(bj.problem, bt.problem, PADDED_FIELDS, (seed, epoch))
        _assert_fields_equal(bj, bt, BOOK_FIELDS, (seed, epoch))
        _assert_stats_agree(ej.run_epoch(), et.run_epoch(), (seed, epoch))
    for f in ("placed", "home", "fill_rate", "epoch"):
        np.testing.assert_array_equal(getattr(ej.pop, f), getattr(et.pop, f), err_msg=f)
    np.testing.assert_array_equal(ej.usage, et.usage)


@pytest.mark.parametrize("seed", SEEDS)
def test_loop_books_match_the_vectorized_packer(seed):
    """The port's two packers: the loop's padded book against the padded
    reconstruction of the vectorized CSR book, and the CSR streams of the
    padded book against the CSR book, bit for bit."""
    eco_v = pt.make_fleet_economy(seed=seed, device="cpu")
    eco_l = pt.make_fleet_economy(seed=seed, packer="loop", device="cpu")
    for epoch in range(EPOCHS):
        ba, bb = _preview(eco_v), _preview(eco_l)
        _assert_fields_equal(pt.padded_from_csr(ba.problem), bb.problem, PADDED_FIELDS,
                             (seed, epoch))
        ca, cb = ba.problem, pt.csr_from_padded(bb.problem)
        assert ca.k_bound == cb.k_bound
        _assert_fields_equal(ca, cb, CSR_FIELDS, (seed, epoch))
        _assert_fields_equal(ba, bb, BOOK_FIELDS, (seed, epoch))
        eco_v.run_epoch()
        eco_l.run_epoch()


@pytest.mark.parametrize("seed", SEEDS)
def test_loop_epochs_bit_identical_to_vectorized(seed):
    """Whole epochs through both packers and both applies agree exactly,
    payments included (one port, one payment fold), and so does the state."""
    eco_v = pt.make_fleet_economy(seed=seed, device="cpu")
    eco_l = pt.make_fleet_economy(seed=seed, packer="loop", device="cpu")
    for epoch in range(EPOCHS):
        _stats_bit_identical(eco_v.run_epoch(), eco_l.run_epoch(), (seed, epoch))
    for f in ("placed", "home", "fill_rate", "epoch"):
        np.testing.assert_array_equal(getattr(eco_v.pop, f), getattr(eco_l.pop, f), err_msg=f)
    np.testing.assert_array_equal(eco_v.usage, eco_l.usage)
    np.testing.assert_array_equal(eco_v.belief, eco_l.belief)


def test_unknown_packer_raises():
    with pytest.raises(ValueError, match="'vectorized' or 'loop'"):
        pt.make_fleet_economy(seed=0, device="cpu", packer="numba")


def _claw_scenario(rng, n, c, t):
    placed = rng.integers(-1, c, size=n)
    req = rng.uniform(0.0, 4.0, size=(n, t))
    req[rng.random((n, t)) < 0.2] = 0.0
    usage = np.zeros((c, t))
    for i in np.flatnonzero(placed >= 0):
        usage[placed[i]] += req[i]
    cap_eff = rng.uniform(1.0, 12.0, size=(c, t)) * rng.uniform(0.3, 1.1, size=(c, 1))
    return placed, req, usage, cap_eff


@pytest.mark.parametrize("seed", range(12))
def test_claw_loop_matches_reference_and_vectorized(seed):
    rng = np.random.default_rng(seed)
    n, c, t = int(rng.integers(1, 60)), int(rng.integers(1, 7)), int(rng.integers(1, 4))
    args = _claw_scenario(rng, n, c, t)
    ev_l, us_l = _claw_to_capacity_loop(*args)
    ev_j, us_j = j_claw_loop(*args)
    ev_v, us_v = _claw_to_capacity(*args)
    for ev, us in ((ev_j, us_j), (ev_v, us_v)):
        np.testing.assert_array_equal(ev_l, ev)
        assert us_l.tobytes() == us.tobytes()  # bitwise, not approx
    assert (us_l <= args[3] + 1e-9).all()


def test_claw_loop_evicts_everyone_when_a_cluster_dies():
    placed = np.array([0, 0, 0, -1])
    req = np.ones((4, 2))
    usage = np.zeros((2, 2))
    usage[0] = 3.0
    ev, us = _claw_to_capacity_loop(placed, req, usage, np.zeros((2, 2)))
    np.testing.assert_array_equal(ev, [True, True, True, False])
    np.testing.assert_array_equal(us, np.zeros((2, 2)))
