"""The port's fused epoch (``Economy(fused=True)``) against the live JAX fused
epoch, on the CPU.

The reference's fused epoch calls ``jax.experimental.enable_x64``, which JAX
0.9.0 removed; JAX still has ``jax.enable_x64``, and the ``x64_shim``
fixture binds the one to the other for these tests, so the reference runs
unchanged.  Contract, as in ``tests/test_torch_economy.py``: prices,
reserves, utilization, rounds, migrations, flags and counts bit for bit,
payment-derived fields to rtol 1e-5; end state (placements, homes, fill
rates, usage, beliefs) bit for bit.  The cases mirror
``tests/test_fused_epoch.py`` on the protocol economies (seeds 0/3/7,
``U_cap = R + 2N ≤ 128``), plus a 5,000-agent fleet past that gate.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.experimental  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jx  # noqa: E402
from repro.core import fused as jfused  # noqa: E402
from repro.core.faults import FaultModel as JFaultModel, RegionFault as JRegionFault  # noqa: E402
from repro_torch import core as pt  # noqa: E402
from repro_torch.core import fused as tfused  # noqa: E402
from repro_torch.core.auction import ClockLoop  # noqa: E402
from repro_torch.core.faults import FaultModel, RegionFault  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SEEDS = (0, 3, 7)
EPOCHS = 4

EXACT_ARRAYS = (
    "prices", "reserve", "psi", "price_ratio", "buy_util_percentiles", "sell_util_percentiles",
)
EXACT_SCALARS = (
    "epoch", "rounds", "migrations", "converged", "system_ok", "pct_settled", "warm_started",
    "degraded", "clock_escalations", "rationed_rows", "dropped_bids", "seller_failures",
    "failed_pools", "evictions", "clawback_units", "arrivals_rejected",
)
PAYMENT_FIELDS = ("gamma_median", "gamma_mean", "surplus", "value_of_trade", "compensation")


@pytest.fixture(autouse=True)
def x64_shim(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _assert_stats_agree(sj, st, where):
    for f in EXACT_ARRAYS:
        a, b = getattr(sj, f), getattr(st, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, f, a, b)
    for f in EXACT_SCALARS:
        a, b = getattr(sj, f), getattr(st, f)
        assert a == b or (a != a and b != b), (where, f, a, b)  # NaN (a dry run's) is NaN
    for f in PAYMENT_FIELDS:
        np.testing.assert_allclose(getattr(st, f), getattr(sj, f), rtol=1e-5, err_msg=f"{where} {f}")


def _assert_state_agrees(ej, et):
    for f in ("placed", "home", "fill_rate", "epoch"):
        np.testing.assert_array_equal(getattr(ej.pop, f), getattr(et.pop, f), err_msg=f)
    np.testing.assert_array_equal(ej.usage, et.usage)
    np.testing.assert_array_equal(ej.belief, et.belief)


def _faults(fm, rf):
    return fm(seed=6, region_faults=(rf(cluster=1, start=1, end=3, scale=0.3),),
              bid_dropout=0.1, seller_fail=0.2, pool_fail=0.1)


def _pair(seed, **kw):
    """(live reference fused economy, the port's fused economy on the CPU)."""
    ej = jx.make_fleet_economy(seed=seed, fused=True, **kw)
    et = pt.make_fleet_economy(seed=seed, fused=True, device="cpu", **kw)
    assert et.R + 2 * len(et.pop) <= tfused.PARITY_MAX_ROWS
    return ej, et


def _run_and_compare(ej, et, epochs=EPOCHS, dry_at=None):
    for e in range(epochs):
        if e == dry_at:
            _assert_stats_agree(ej.run_epoch(dry_run=True), et.run_epoch(dry_run=True), ("dry", e))
        _assert_stats_agree(ej.run_epoch(), et.run_epoch(), e)
    _assert_state_agrees(ej, et)


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_matches_jax_plain(seed):
    _run_and_compare(*_pair(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_matches_jax_warm_decay(seed):
    _run_and_compare(*_pair(seed, warm_start=True, warm_decay=0.5))


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_matches_jax_policies(seed):
    ej = jx.make_fleet_economy(seed=seed, fused=True, policies=[
        jx.StaticPolicy(), jx.PriceChasingPolicy(), jx.BudgetSmoothingPolicy()])
    et = pt.make_fleet_economy(seed=seed, fused=True, device="cpu", policies=[
        pt.StaticPolicy(), pt.PriceChasingPolicy(), pt.BudgetSmoothingPolicy()])
    for eco in (ej, et):
        eco.pop.policy[:] = np.arange(len(eco.pop)) % 3
    _run_and_compare(ej, et)


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_matches_jax_faults(seed):
    """Region fault, dropout, seller flakes and pool failures with the
    escalation ladder and proportional rationing armed."""
    kw = dict(clock_retries=2, ration_fallback=True)
    ej = jx.make_fleet_economy(seed=seed, fused=True, faults=_faults(JFaultModel, JRegionFault), **kw)
    et = pt.make_fleet_economy(seed=seed, fused=True, device="cpu",
                               faults=_faults(FaultModel, RegionFault), **kw)
    _run_and_compare(ej, et)
    np.testing.assert_array_equal(ej.pool_reliability, et.pool_reliability)


@pytest.mark.parametrize("seed", (0, 3))
def test_fused_matches_jax_rationing(seed):
    """A round-starved clock that does not converge: the proportional
    rationing of winning buys, on the fused path."""
    kw = dict(clock_retries=0, ration_fallback=True)
    ej = jx.make_fleet_economy(seed=seed, fused=True, clock=jx.ClockConfig(max_rounds=6), **kw)
    et = pt.make_fleet_economy(seed=seed, fused=True, device="cpu",
                               clock=pt.ClockConfig(max_rounds=6), **kw)
    rationed = 0
    for e in range(3):
        sj, st = ej.run_epoch(), et.run_epoch()
        _assert_stats_agree(sj, st, e)
        rationed += st.rationed_rows
    assert rationed > 0
    _assert_state_agrees(ej, et)


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_dry_run_interleaves(seed):
    """A dry run mid-horizon leaves the device state, the mirrors and the RNG
    as they were."""
    _run_and_compare(*_pair(seed), dry_at=1)


@pytest.mark.parametrize("seed", SEEDS)
def test_pipeline_horizon_matches_sequential_and_jax(seed):
    ej = jx.make_fleet_economy(seed=seed, fused=True, warm_start=True)
    seq = pt.make_fleet_economy(seed=seed, fused=True, warm_start=True, device="cpu")
    pipe = pt.make_fleet_economy(seed=seed, fused=True, pipeline=True, warm_start=True,
                                 device="cpu")
    sjs = [ej.run_epoch() for _ in range(EPOCHS)]
    sss = [seq.run_epoch() for _ in range(EPOCHS)]
    sps = pipe.run_horizon(EPOCHS)
    assert len(sps) == EPOCHS
    for e, (sj, ss, sp) in enumerate(zip(sjs, sss, sps)):
        _assert_stats_agree(sj, sp, e)
        da, db = dataclasses.asdict(ss), dataclasses.asdict(sp)
        for k in da:  # pipelined == sequential, every field bit for bit
            if isinstance(da[k], np.ndarray):
                assert da[k].dtype == db[k].dtype and np.array_equal(da[k], db[k]), (e, k)
            else:
                assert da[k] == db[k] or (da[k] != da[k] and db[k] != db[k]), (e, k)
    _assert_state_agrees(ej, pipe)


def test_run_horizon_unpipelined_is_sequential():
    a = pt.make_fleet_economy(seed=0, fused=True, device="cpu")
    b = pt.make_fleet_economy(seed=0, fused=True, device="cpu")
    for e, (sa, sb) in enumerate(zip([a.run_epoch() for _ in range(2)], b.run_horizon(2))):
        _assert_stats_agree(sa, sb, e)
    _assert_state_agrees(a, b)


def test_fused_builds_its_stages_once_across_fault_and_clean_epochs():
    """8 epochs across clean, region-fault, dropout and flake epochs, with
    escalation and rationing armed: the program keeps the stages it built
    (pack, settle, one clock chunk a ladder stage run), one of each, with
    the same static tensors — the twin of the reference's one compiled
    variant."""
    eco = pt.make_fleet_economy(seed=3, fused=True, device="cpu", faults=_faults(
        FaultModel, RegionFault), clock_retries=2, ration_fallback=True)
    eco.run_epoch()
    fn = eco._fused_fn
    stages = dict(fn._stages)
    statics = {k: v.data_ptr() for k, v in fn._in.items()}
    for _ in range(7):
        eco.run_epoch()
    assert eco._fused_fn is fn
    assert {"pack", "settle", "clock0"} <= set(fn._stages) <= {"pack", "settle", "clock0",
                                                                "clock1", "clock2"}
    assert all(fn._stages[k] is v for k, v in stages.items())
    assert {k: v.data_ptr() for k, v in fn._in.items()} == statics
    assert tfused.fused_program_cache_size(fn) == len(fn._stages)


def test_fused_constructor_validation():
    with pytest.raises(ValueError, match="pipeline=True requires fused"):
        pt.make_fleet_economy(seed=0, device="cpu", pipeline=True)
    with pytest.raises(ValueError, match="packer='vectorized'"):
        pt.make_fleet_economy(seed=0, device="cpu", fused=True, packer="loop")
    with pytest.raises(ValueError, match="policies=None and faults=None"):
        pt.make_fleet_economy(seed=0, device="cpu", fused=True, pipeline=True,
                              faults=_faults(FaultModel, RegionFault))
    with pytest.raises(ValueError, match="fused_slack=True requires fused"):
        pt.make_fleet_economy(seed=0, device="cpu", fused_slack=True)
    with pytest.raises(ValueError, match="'z'"):
        pt.make_fleet_economy(seed=0, device="cpu", fused=True, fused_backend="interpret")
    with pytest.raises(ValueError, match="break_ties"):
        tfused.build_fused_epoch(num_agents=4, num_clusters=2, num_rtypes=3,
                                 clock=pt.ClockConfig(break_ties=True))


def test_fused_population_churn_rebuilds():
    """Departures change N: the program is rebuilt and the device state
    uploaded again from the mirrors; stats keep matching the reference."""
    ej, et = _pair(5)
    _assert_stats_agree(ej.run_epoch(), et.run_epoch(), 0)
    first = et._fused_fn
    keep = np.ones(len(ej.pop), bool)
    keep[::7] = False
    ej.remove_agents(~keep)
    et.remove_agents(~keep)
    _assert_stats_agree(ej.run_epoch(), et.run_epoch(), 1)
    assert et._fused_fn is not first and et._fused_fn.N == len(et.pop)
    _assert_state_agrees(ej, et)


def test_fused_slack_keeps_one_program_across_churn_and_matches_jax():
    """``fused_slack`` pads the agent axis to a power of two: bounded churn
    keeps the built program (same capacity, same static tensors), and the
    padded epochs match the reference's padded ones."""
    ej, et = (mod.make_fleet_economy(seed=0, fused=True, fused_slack=True, **kw)
              for mod, kw in ((jx, {}), (pt, {"device": "cpu"})))
    cap0 = et._fused_cap()
    assert cap0 == ej._fused_cap() and cap0 >= len(et.pop) and cap0 & (cap0 - 1) == 0
    prog = None
    for epoch in range(3):
        if epoch == 1:
            prog = et._fused_fn
            for eco, mod in ((ej, jx), (et, pt)):
                keep = np.ones(len(eco.pop), bool)
                keep[::9] = False
                eco.remove_agents(~keep)
                eco.add_agents(mod.fleet_population(3, eco.C, seed=11, placed_frac=0.0))
        _assert_stats_agree(ej.run_epoch(), et.run_epoch(), epoch)
    assert et._fused_fn is prog and et._fused_cap() == cap0 and et._fused_fn.N == cap0
    _assert_state_agrees(ej, et)


def test_settlement_and_fused_z_adapters():
    """``ops.settlement_demand_fn`` and ``ops.fused_epoch_z_fn``, the twins of
    the reference's: exact → the blocked fold bit for bit, else z mode;
    ``None`` keeps the exact fold in the fused loop, ``"z"`` is the z-mode
    kernel's z, a TPU backend name raises."""
    rng = np.random.default_rng(0)
    u, b, k, r = 40, 3, 2, 6
    idx = torch.from_numpy(rng.integers(0, r, (u, b, k)).astype(np.int32))
    val = torch.from_numpy(rng.uniform(-2, 4, (u, b, k)).astype(np.float32))
    mask = torch.from_numpy(rng.random((u, b)) < 0.8)
    pi = torch.from_numpy(rng.uniform(-5, 40, (u, b)).astype(np.float32))
    prices = torch.from_numpy(rng.random(r).astype(np.float32))
    args = (idx, val, mask, pi, prices, r)
    z, chosen, _ = ops.settlement_demand_fn(exact=True)(*args)
    z_b, chosen_b, _ = pt.sparse_proxy_demand_blocked(*args)
    assert torch.equal(z, z_b) and torch.equal(chosen, chosen_b)
    z_s, chosen_s, _ = ops.settlement_demand_fn(exact=False)(*args)
    assert torch.equal(chosen_s, chosen_b) and torch.allclose(z_s, z_b, rtol=1e-5, atol=1e-5)
    assert ops.fused_epoch_z_fn(None, r) is None
    assert torch.equal(ops.fused_epoch_z_fn("z", r)(*args[:5]), z_s)
    for backend in ("pallas", "interpret", "jnp"):
        with pytest.raises(ValueError, match="'z'"):
            ops.fused_epoch_z_fn(backend, r)


def test_fused_z_backend_settles_close_to_jax_interpret():
    """The z-mode kernel's in-loop z (its plain version on the CPU) against
    the reference's interpret backend: a float-close trajectory, exact
    selection and settlement, converged and SYSTEM-feasible."""
    ej = jx.make_fleet_economy(seed=0, fused=True, fused_backend="interpret")
    et = pt.make_fleet_economy(seed=0, fused=True, fused_backend="z", device="cpu")
    sj, st = ej.run_epoch(), et.run_epoch()
    np.testing.assert_allclose(st.prices, sj.prices, rtol=1e-5, atol=1e-5)
    assert st.converged and st.system_ok


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_fused_5000_agents_match_jax(warm):
    """Past the parity gate: fleet_economy(5_000, 8, seed=0), U_cap = 10,024
    rows, m_cap = 1,253 rows a settlement block (two fold levels)."""
    ej = jx.fleet_economy(5_000, 8, seed=0, warm_start=warm, fused=True)
    et = pt.fleet_economy(5_000, 8, seed=0, warm_start=warm, fused=True, device="cpu")
    for e in range(3):
        _assert_stats_agree(ej.run_epoch(), et.run_epoch(), (warm, e))
    _assert_state_agrees(ej, et)


def test_state_tree_of_a_fused_economy_carries_over():
    """A fused economy's state tree (its device state brought back into the
    mirrors) loads into a new fused economy, which uploads it: both settle
    the next epochs as the reference does."""
    ej, et = _pair(7, warm_start=True)
    _assert_stats_agree(ej.run_epoch(), et.run_epoch(), 0)
    tree, rng_state = pt.economy_state(et)
    back = pt.make_fleet_economy(seed=7, warm_start=True, fused=True, device="cpu")
    back.run_epoch()  # a device state of its own, to be replaced
    pt.load_economy_state(back, tree, rng_state)
    for e in range(1, 3):
        sj = ej.run_epoch()
        _assert_stats_agree(sj, et.run_epoch(), ("fused", e))
        _assert_stats_agree(sj, back.run_epoch(), ("loaded", e))
    _assert_state_agrees(ej, et)
    _assert_state_agrees(ej, back)


# ---------------------------------------------------------------------------
# the program's parts
# ---------------------------------------------------------------------------


def _live_demand(num_agents, num_clusters, num_rtypes):
    """The reference's own ``_demand`` closure out of its fused program, jitted."""
    prog = jfused.build_fused_epoch(num_agents=num_agents, num_clusters=num_clusters,
                                    num_rtypes=num_rtypes, clock=jx.ClockConfig())
    fn = prog.__wrapped__
    cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    return jax.jit(cells["_demand"]), cells["U_cap"]


def _slot_book(rng, u_cap, b, k, r, neg_zero_pool=None):
    idx = rng.integers(0, r, (u_cap, b, k)).astype(np.int32)
    val = (rng.uniform(-2, 4, (u_cap, b, k)) * 10.0 ** rng.integers(-2, 3, (u_cap, b, k))
           ).astype(np.float32)
    mask = rng.random((u_cap, b)) < 0.8
    pi = rng.uniform(-5, 40, (u_cap, b)).astype(np.float32)
    present = rng.random(u_cap) < 0.7
    if neg_zero_pool is not None:  # every chosen term -0.0 on one pool
        idx[:] = neg_zero_pool
        val[:] = -0.0
        present[:] = True
    pi[~mask] = -np.inf
    mask[~present], pi[~present], idx[~present], val[~present] = False, -np.inf, 0, 0
    return idx, val, mask, pi, rng.random(r).astype(np.float32), present


@pytest.mark.parametrize("m_cap,neg_zero", [
    (1, True), (5, False), (15, False), (15, True), (16, False), (20, False), (24, True),
    (31, False), (32, False), (33, False), (100, True), (1_253, False),
])
def test_blocked_demand_matches_live_reference(m_cap, neg_zero):
    """The program's settlement demand (present rows scattered into the
    blocked book, the partials kernel's plain version in the stand-alone fold
    form, the left fold over blocks) against the reference's ``_demand``,
    bit for bit, across the fold regimes; with ``neg_zero`` every term is
    -0.0 on pool 0."""
    rng = np.random.default_rng(m_cap)
    C, T = (2, 1) if m_cap == 1 else (4, 3)
    R = C * T
    N = (8 * m_cap - R) // 2
    live, u_cap = _live_demand(N, C, T)
    prog = tfused.build_fused_epoch(num_agents=N, num_clusters=C, num_rtypes=T,
                                    clock=pt.ClockConfig())
    assert prog.U_cap == u_cap and prog.m_cap == m_cap
    idx, val, mask, pi, prices, present = _slot_book(rng, u_cap, C, T, R, 0 if neg_zero else None)
    q = np.cumsum(present) - present
    with jax.enable_x64(True):
        z, chosen, _ = live(*(jnp.asarray(a) for a in (idx, val, mask, pi, prices, q, present,
                                                        np.int64(present.sum()))))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    u = int(present.sum())
    m_st = -(-u // 8)
    dest = np.where(present, (q // m_st) * m_cap + q % m_st, 8 * m_cap)
    book = {}
    for name, a, fill in (("b_idx", idx, 0), ("b_val", val, 0.0), ("b_mask", mask, False),
                          ("b_pi", pi, -np.inf)):
        blk = np.full((8 * m_cap + 1,) + a.shape[1:], fill, a.dtype)
        blk[dest] = a
        book[name] = t(blk[:-1])
    prog._book = book
    z_t, chosen_blk = prog._blocked(t(prices))
    assert np.array_equal(np.asarray(z).view(np.int32), z_t.numpy().view(np.int32))
    got = np.where(present, chosen_blk.numpy()[np.minimum(dest, 8 * m_cap - 1)], -1)
    np.testing.assert_array_equal(got, np.asarray(chosen))


def test_npsum_f32_matches_numpy_sum():
    rng = np.random.default_rng(0)
    for n in range(129):
        x = (rng.uniform(-3, 5, n) * 10.0 ** rng.integers(-4, 5, n)).astype(np.float32)
        buf = np.zeros(128, np.float32)
        buf[:n] = x
        got = tfused._npsum_f32(torch.from_numpy(buf), torch.tensor(n))
        assert np.float32(got.item()).tobytes() == np.sum(x, dtype=np.float32).tobytes(), n


@pytest.mark.parametrize("cfg", [
    dict(max_rounds=3000, alpha=0.6, delta=0.25),
    dict(max_rounds=3000, alpha=0.3, delta=0.25, alpha_growth=1.6, delta_decay=0.6),
    dict(max_rounds=13, alpha=0.05, delta=0.05, alpha_growth=1.6, delta_decay=0.6),
], ids=["fixed", "adaptive", "starved"])
def test_clock_chunks_match_the_reference_loop(cfg):
    """The eager chunk function against the reference's ``while_loop``: the
    same rounds and prices after chunks of CHECK_EVERY rounds (so the
    adaptive state carries across chunks), and chunks issued after the loop
    stopped change nothing."""
    book = jx.random_market(300, 12, seed=4)
    sp = jx.SparseAuctionProblem(**{f.name: getattr(book, f.name)
                                    for f in dataclasses.fields(book)})
    start = np.full(12, 0.1, np.float32)
    res_j = jx.clock_auction(sp, jnp.asarray(start), jx.ClockConfig(**cfg),
                             demand_fn=jx.sparse_proxy_demand_blocked)
    a = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    idx, val, mask, pi = a(sp.idx), a(sp.val), a(sp.bundle_mask), a(sp.pi)
    demand = ops.blocked_bid_demand_fn(8)
    loop = ClockLoop(lambda p: demand(idx, val, mask, pi, p, 12)[0], pt.ClockConfig(**cfg),
                     a(sp.base_cost), a(sp.supply_scale))
    loop.reset(a(start))
    while loop.running():
        loop.chunk()
    assert int(loop.t) == int(res_j.rounds)
    np.testing.assert_array_equal(loop.p.numpy(), np.asarray(res_j.prices))
    state = [x.clone() for x in (loop.t, loop.done, loop.p, loop.p_prev)]
    loop.chunk()
    loop.chunk()
    for before, after in zip(state, (loop.t, loop.done, loop.p, loop.p_prev)):
        assert torch.equal(before, after)


def test_recorded_reference_matches_the_port():
    """``tools/record_reference.py`` at 2,000 agents against the port's CPU
    runs, staged and fused: every recorded field of every epoch."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "record_reference.py"
    spec = importlib.util.spec_from_file_location("record_reference", path)
    rec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rec)
    want = rec.record(agents=2_000, clusters=8, seed=0, epochs=3)
    for name, epochs in want["runs"].items():
        path_, restarts = name.split(" ", 1)
        eco = pt.fleet_economy(2_000, 8, seed=0, warm_start=rec.RESTARTS[restarts],
                               fused=path_ == "fused", device="cpu")
        got = [rec.epoch_record(eco.run_epoch(), eco) for _ in range(3)]
        assert rec.mismatches(epochs, got) == [], name
