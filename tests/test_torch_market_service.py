"""The port's always-on MarketService against the live reference's, tick for tick.

Both services are bridged over the same ``fleet_economy`` and fed the same
delta stream: re-priced submissions, malformed and oversized ones
(rejections), fresh keys past ``max_pending`` (backpressure), withdrawals
known and unknown, bid-stream dropout faults, a zero deadline, a
round-starved clock rescued by the escalation ladder, previews, and
``sync_from_economy`` after ``add_agents``, ``remove_agents`` and policy
actions.  Contract: prices, psi, rounds, ``pct_settled``, every flag,
counter and health field, and the book's arrays are bit-identical;
``gamma_*``, ``surplus`` and ``value_of_trade`` (derived from payments) agree
to rtol 1e-5.  ``rows_cap`` from 64 to 4,096 (m = 8..512 rows a settlement
block) runs the partials fold in its vectorized form.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import repro.core.auction as jauction  # noqa: E402
import repro.core.faults as jfaults  # noqa: E402
import repro.core.markets as jmarkets  # noqa: E402
import repro.core.policies as jpolicies  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro.serve.market as jmarket  # noqa: E402
import repro_torch.core as pt  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
import repro_torch.serve.market as tmarket  # noqa: E402

JAX = types.SimpleNamespace(
    fleet_economy=jmarkets.fleet_economy, fleet_population=jmarkets.fleet_population,
    FaultModel=jfaults.FaultModel, ClockConfig=jauction.ClockConfig,
    StaticPolicy=jpolicies.StaticPolicy, PriceChasingPolicy=jpolicies.PriceChasingPolicy,
    ServiceConfig=jserve.ServiceConfig, MarketService=jmarket.MarketService,
    BidDelta=jmarket.BidDelta, device={},
)
PORT = types.SimpleNamespace(
    fleet_economy=pt.fleet_economy, fleet_population=pt.fleet_population,
    FaultModel=pt.FaultModel, ClockConfig=pt.ClockConfig,
    StaticPolicy=pt.StaticPolicy, PriceChasingPolicy=pt.PriceChasingPolicy,
    ServiceConfig=tserve.ServiceConfig, MarketService=tmarket.MarketService,
    BidDelta=tmarket.BidDelta, device={"device": "cpu"},
)
PAYMENT = ("gamma_median", "gamma_mean", "surplus", "value_of_trade")


def _repriced(pkg, eco, rng, n, scale_lo=0.9):
    keys, idx, val, mask, pi = eco.export_bid_rows()
    live = np.flatnonzero(mask.any(axis=1))
    pick = rng.choice(live, size=min(n, live.size), replace=False)
    scale = rng.uniform(scale_lo, 1.1, pick.size).astype(np.float32)
    return [pkg.BidDelta(keys[i], [(idx[i, b], val[i, b]) for b in np.flatnonzero(mask[i])],
                         pi[i][mask[i]] * scale[j]) for j, i in enumerate(pick)]


def _full_stream(pkg, seed):
    """The scenario of the module docstring → (per-step records, service)."""
    eco = pkg.fleet_economy(
        200, 4, seed=seed, policy=np.arange(200) % 2,
        policies=[pkg.StaticPolicy(), pkg.PriceChasingPolicy()], **pkg.device)
    cfg = pkg.ServiceConfig(max_pending=14)
    svc = pkg.MarketService.from_economy(
        eco, config=cfg, faults=pkg.FaultModel(bid_dropout=0.05, seed=seed))
    rng = np.random.default_rng(seed)
    r = svc.book.num_resources
    out = []
    for t in range(5):
        acks = [svc.submit(d) for d in _repriced(pkg, eco, rng, 10)]
        acks += [
            svc.submit(pkg.BidDelta(f"bad-pool-{t}", [([r + 5], [1.0])], [5.0])),
            svc.submit(pkg.BidDelta(f"bad-pi-{t}", [([0], [1.0])], [np.nan])),
            svc.submit(pkg.BidDelta(f"huge-{t}", [([1], [2e6])], [5.0])),
            svc.submit(pkg.BidDelta(f"empty-{t}", [], [5.0])),
            svc.withdraw(f"unknown-{t}"),
        ]
        if t == 1:  # fresh keys past max_pending are deferred
            acks += [svc.submit(pkg.BidDelta(f"fresh-{i}", [([i % r], [1.0])], [1e-3]))
                     for i in range(8)]
        if t in (2, 4):
            keys = eco.export_bid_rows()[0]
            acks += [svc.withdraw(keys[int(rng.integers(len(keys)))]) for _ in range(3)]
        out.append(("acks", acks, svc.pending))
        out.append(("preview", svc.preview()))
        if t == 1:
            st = svc.tick(deadline_s=0.0)  # one attempt, then the deadline is gone
        elif t == 2:  # a round-starved cold clock, rescued by the ladder
            svc.clock, svc.warm_start, svc.max_escalations = pkg.ClockConfig(max_rounds=40), False, 8
            st = svc.tick()
            svc.clock, svc.warm_start = pkg.ClockConfig(), True
        elif t == 3:  # the same starved clock with no ladder fails the tick
            svc.clock, svc.warm_start, svc.max_escalations = pkg.ClockConfig(max_rounds=40), False, 0
            st = svc.tick()
            svc.clock, svc.warm_start, svc.max_escalations = pkg.ClockConfig(), True, 2
        else:
            st = svc.tick()
        out.append(("tick", st, dataclasses.asdict(svc.health), svc.poll_prices()))
        if t == 2:  # the economy churns and acts; the bridge resyncs in O(Δ)
            keep = np.ones(len(eco.pop), bool)
            keep[::9] = False
            eco.remove_agents(~keep)
            eco.add_agents(pkg.fleet_population(7, eco.C, seed=seed + 1, placed_frac=0.0))
            eco.run_epoch()  # policy actions mark their agents dirty
            out.append(("sync", svc.sync_from_economy(eco)))
    return out, svc


def _assert_stats(sj, st, where):
    dj, dt = dataclasses.asdict(sj), dataclasses.asdict(st)
    assert dj.keys() == dt.keys()
    for k, vj in dj.items():
        vt = dt[k]
        if k in PAYMENT:
            np.testing.assert_allclose(vt, vj, rtol=1e-5, err_msg=f"{where} {k}")
        elif isinstance(vj, np.ndarray):
            assert vj.dtype == vt.dtype and np.array_equal(vj, vt), (where, k, vj, vt)
        else:
            assert vj == vt or (vj != vj and vt != vt), (where, k, vj, vt)


def _assert_books(bj, bt, where):
    (aj, mj), (at, mt) = bj.export_state(), bt.export_state()
    assert mj == mt, where
    for k in aj:
        assert aj[k].dtype == at[k].dtype and np.array_equal(aj[k], at[k]), (where, k)


@pytest.mark.parametrize("seed", [1, 4])
def test_service_stream_matches_reference(seed):
    ref, svc_j = _full_stream(JAX, seed)
    got, svc_t = _full_stream(PORT, seed)
    assert [r[0] for r in ref] == [g[0] for g in got]
    kinds = set()
    for step, (rj, rt) in enumerate(zip(ref, got)):
        where = (seed, step, rj[0])
        if rj[0] in ("acks", "sync"):
            assert rj[1:] == rt[1:], where
        else:
            _assert_stats(rj[1], rt[1], where)
        if rj[0] == "tick":
            assert rj[2] == rt[2], where
            assert np.array_equal(rj[3][0], rt[3][0]) and rj[3][1] == rt[3][1], where
            st = rt[1]
            kinds.update(k for k, on in (
                ("rejected", st.bids_rejected), ("deferred", st.bids_deferred),
                ("dropped", st.dropped_bids), ("missed", st.deadline_missed),
                ("escalated", st.clock_escalations), ("failed", not st.converged),
                ("withdrawn", st.bids_withdrawn)) if on)
    # the stream reached every path it is meant to
    assert kinds == {"rejected", "deferred", "dropped", "missed", "escalated", "failed",
                     "withdrawn"}, kinds
    _assert_books(svc_j.book, svc_t.book, seed)
    svc_t.book.parity_check()


# rows_cap -> the fleet that fills it (agents, clusters): 8 blocks of m rows
ROWS_CAPS = {64: (40, 3), 128: (100, 3), 256: (200, 4), 512: (200, 4), 1024: (200, 4),
             2048: (200, 4), 4096: (200, 4)}


def _cap_stream(pkg, rows_cap):
    agents, clusters = ROWS_CAPS[rows_cap]
    eco = pkg.fleet_economy(agents, clusters, seed=1, **pkg.device)
    svc = pkg.MarketService.from_economy(
        eco, config=pkg.ServiceConfig(rows_cap=rows_cap),
        faults=pkg.FaultModel(bid_dropout=0.1, seed=1))
    rng = np.random.default_rng(rows_cap)
    out = []
    for _ in range(3):
        for d in _repriced(pkg, eco, rng, 6, scale_lo=0.7):
            svc.submit(d)
        out.append(svc.tick())
    return out, svc


@pytest.mark.parametrize("rows_cap", sorted(ROWS_CAPS))
def test_rows_cap_vectorized_fold_matches_reference(rows_cap):
    ref, svc_j = _cap_stream(JAX, rows_cap)
    got, svc_t = _cap_stream(PORT, rows_cap)
    assert svc_t.book.rows_cap == rows_cap
    for t, (sj, st) in enumerate(zip(ref, got)):
        _assert_stats(sj, st, (rows_cap, t))
        assert st.converged
    _assert_books(svc_j.book, svc_t.book, rows_cap)
