"""The port's spans (``repro_torch.trace``), on the CPU.

* With no profile recording, a span is one shared no-op context and
  ``record_function`` is never called, not in a whole fused epoch or a
  service tick either.
* Under ``torch.profiler``, a fused epoch and a service tick record their
  stages as host ranges, each inside the stage that calls it.
* A binding tick's ``last_tick_timings`` keep every key they had and add
  the commit's phases: the snapshot, and with a blocking save the write and
  the publish, which add up to no more than the commit.
* An economy with bidder policies records each policy's ``act`` and the
  marking of the acting agents under ``economy.policies``, and counts what
  the policies did in ``last_policy_counts``; one without policies keeps
  no counts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small books: more threads only contend with the other test workers

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch.core as pt  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
import repro_torch.serve.market as tmarket  # noqa: E402
from repro_torch import trace  # noqa: E402

PREFIXES = ("economy", "fused", "service")
TICK_KEYS = {"drain_ms", "sync_ms", "sync_rows", "settle_ms", "capture_ms", "commit_ms",
             "record", "tick_ms"}
PHASES = ("commit_snapshot_ms", "commit_write_ms", "commit_publish_ms")


def _economy(agents=1000):
    return pt.fleet_economy(agents, 4, seed=3, fused=True, device="cpu")


def _adaptive(agents=1000, **kw):
    """The fleet with the three shipped policies: agents homed in the two
    congested clusters chase prices, the rest alternate static and budget
    smoothing."""
    from repro_torch.core.policies import POLICY_REGISTRY

    eco = pt.fleet_economy(agents, 4, seed=3, fused=True, device="cpu", **kw,
                           policies=[POLICY_REGISTRY[k]() for k in POLICY_REGISTRY])
    pop = eco.pop
    pop.policy[:] = np.where(pop.home < 2, 1, np.arange(len(pop)) % 2 * 2)
    return eco


def _service(tmp_path, **config):
    cfg = tserve.ServiceConfig(wal_path=str(tmp_path / "m.wal"),
                               checkpoint_dir=str(tmp_path / "ck"), **config)
    eco = pt.fleet_economy(300, 3, seed=2, device="cpu")
    return eco, tmarket.MarketService.from_economy(eco, config=cfg)


def _deltas(eco, svc, t):
    keys, idx, val, mask, pi = eco.export_bid_rows()
    live = [i for i in range(len(keys)) if mask[i].any()]
    for j, i in enumerate(live[3 * t:3 * t + 3]):
        svc.submit(tmarket.BidDelta(keys[i], [(idx[i, b], val[i, b]) for b in range(mask.shape[1])
                                              if mask[i, b]], pi[i][mask[i]] * (0.9 + 0.05 * j)))
    svc.withdraw(keys[live[-1 - t]])


def _ranges(prof):
    """The profile's host ranges of the program's layers: (name, start, end)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().split(".")[0] in PREFIXES:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _within(ranges, inner, outers):
    """Every range ``inner`` lies inside a range named in ``outers``."""
    spans = [(s, e) for n, s, e in ranges if n in outers]
    got = [(s, e) for n, s, e in ranges if n == inner]
    assert got, f"no {inner} range"
    for s, e in got:
        assert any(os_ <= s and e <= oe for os_, oe in spans), f"{inner} outside {outers}"


def test_off_a_span_is_a_shared_no_op_and_never_records(monkeypatch, tmp_path):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profile recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("economy.epoch") is trace.span("service.tick")
    with trace.span("fused.clock"):
        pass

    @trace.traced("economy.prepare")
    def double(x):
        return 2 * x

    assert double(4) == 8 and double.__name__ == "double"
    watch = trace.Stopwatch()
    for _ in range(2):
        with watch.stage("service.drain", "drain_ms"):
            pass
    assert list(watch.ms) == ["drain_ms"] and watch.ms["drain_ms"] >= 0.0
    # the main paths: a fused epoch, a service's deltas and tick
    assert _economy(200).run_epoch().converged
    eco, svc = _service(tmp_path)
    _deltas(eco, svc, 0)
    assert svc.tick().converged


def test_a_fused_epoch_records_its_stages_nested():
    eco = _economy()
    eco.run_epoch()  # the stages built
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = eco.run_epoch()
    assert stats.converged
    got = _ranges(prof)
    assert sum(n == "economy.epoch" for n, _, _ in got) == 1
    for name in ("economy.prepare", "economy.dispatch", "economy.adopt", "economy.finalize"):
        _within(got, name, {"economy.epoch"})
    for name in ("economy.faults", "economy.reserve", "economy.draws", "economy.policies",
                 "economy.margins", "economy.percentiles"):
        _within(got, name, {"economy.prepare"})
    for name in ("economy.upload", "fused.pack", "fused.clock", "fused.settle"):
        _within(got, name, {"economy.dispatch"})
    _within(got, "fused.clock.chunk", {"fused.clock"})
    _within(got, "fused.clock.check", {"fused.clock", "economy.dispatch"})
    chunks = sum(n == "fused.clock.chunk" for n, _, _ in got)
    checks = sum(n == "fused.clock.check" for n, _, _ in got)
    assert chunks == -(-stats.rounds // 8) and checks >= chunks  # one pair a chunk at most


@pytest.mark.parametrize("async_commit", [False, True], ids=["blocking", "async"])
def test_a_tick_records_its_stages_and_the_commit_phases(tmp_path, async_commit):
    eco, svc = _service(tmp_path, checkpoint_full_every=2, async_commit=async_commit)
    kinds = []
    for t in range(3):
        _deltas(eco, svc, t)
        if t == 2:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                svc.tick()
        else:
            svc.tick()
        timings = svc.last_tick_timings
        assert TICK_KEYS <= set(timings)
        kinds.append(timings["record"])
        phases = [k for k in PHASES if k in timings]
        assert phases == (["commit_snapshot_ms"] if async_commit else list(PHASES))
        assert all(timings[k] >= 0.0 for k in phases)
        assert sum(timings[k] for k in phases) <= timings["commit_ms"]
    assert kinds == ["delta", "delta", "full"]
    svc.flush()
    got = _ranges(prof)
    for name in ("service.drain", "service.sync", "service.settle", "service.commit"):
        _within(got, name, {"service.tick"})
    _within(got, "service.commit.snapshot", {"service.commit"})
    if not async_commit:
        for name in ("service.commit.write", "service.commit.publish"):
            _within(got, name, {"service.commit"})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _deltas(eco, svc, 3)
    got = _ranges(prof)
    assert sum(n == "service.submit" for n, _, _ in got) == 3
    _within(got, "service.wal_append", {"service.submit", "service.withdraw"})


def test_a_tick_without_a_record_times_the_wal_sync(tmp_path):
    cfg = tserve.ServiceConfig(wal_path=str(tmp_path / "m.wal"))
    eco = pt.fleet_economy(300, 3, seed=2, device="cpu")
    svc = tmarket.MarketService.from_economy(eco, config=cfg)
    _deltas(eco, svc, 0)
    svc.tick()
    timings = svc.last_tick_timings
    assert TICK_KEYS <= set(timings) and timings["record"] is None
    assert [k for k in PHASES if k in timings] == ["commit_publish_ms"]
    assert timings["commit_publish_ms"] <= timings["commit_ms"]


def test_an_epoch_records_each_policy_and_the_marking():
    eco = _adaptive()
    eco.run_epoch()  # prices to chase
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eco.run_epoch()
    got = _ranges(prof)
    for name in ("economy.policies.static", "economy.policies.price_chasing",
                 "economy.policies.budget_smoothing", "economy.policies.mark"):
        _within(got, name, {"economy.policies"})


def test_policy_counts_are_what_the_actions_did():
    eco = _adaptive()
    for epoch in range(3):
        obs, pop = eco.observation(), eco.pop
        want = dict.fromkeys(("policy_acted", "policy_redraws", "policy_sellers",
                              "policy_margin_overrides"), 0)
        for pid, pol in enumerate(eco.policies):
            idx = np.flatnonzero(pop.policy == pid)
            act = pol.act(obs, pop, idx)
            if act is None:
                continue
            want["policy_acted"] += idx.size
            if act.redraw_reach is not None:
                want["policy_redraws"] += int(np.sum(act.redraw_reach))
            if act.arbitrage is not None:
                want["policy_sellers"] += int(np.sum(act.arbitrage > pop.arbitrage[idx]))
            if act.margin is not None:
                want["policy_margin_overrides"] += int(np.sum(act.margin != pop.margins()[idx]))
        eco.run_epoch()
        assert eco.last_policy_counts == want
        if epoch:  # the chasers act once there are prices
            assert want["policy_redraws"] > 0 and want["policy_margin_overrides"] > 0
    eco.run_epoch(dry_run=True)
    assert eco.last_policy_counts == want  # a dry run counts nothing


def test_without_policies_no_counts_and_the_same_epochs():
    from repro_torch.core.policies import StaticPolicy

    plain = pt.fleet_economy(1000, 4, seed=3, fused=True, device="cpu")
    static = pt.fleet_economy(1000, 4, seed=3, fused=True, device="cpu",
                              policies=[StaticPolicy()])
    for _ in range(3):
        a, b = plain.run_epoch(), static.run_epoch()
        assert np.array_equal(a.prices, b.prices) and a.rounds == b.rounds
        assert a.migrations == b.migrations and a.surplus == b.surplus
    assert plain.last_policy_counts == {}
    assert static.last_policy_counts["policy_acted"] == 0
    assert np.array_equal(plain.pop.placed, static.pop.placed)
    assert np.array_equal(plain.usage, static.usage)
