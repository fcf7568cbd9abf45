"""The port's scenario engine against the live JAX reference, on the CPU.

Each case runs through both packages' ``run_scenario`` with
``tools/record_scenario_reference.py``'s ``run_case`` and is compared with
its ``mismatches``: prices, reserves, psi, the chosen bundles of each
epoch's last clock, placements, rounds, migrations, the flags and counts,
the utilization-spread series, the event reports and the final pool
reliability bit for bit; the payment-derived stats to rtol 1e-5 (the port's
payment fold is not XLA's).  The golden-backed scenarios are held to the
live run, not to ``tests/golden/``, which JAX 0.9.0 does not reproduce.
"""
import dataclasses
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.experimental  # noqa: E402

import repro.core as jx  # noqa: E402
from repro.core import scenarios as jscen  # noqa: E402
from repro_torch import core as pt  # noqa: E402
from repro_torch.core import scenarios as tscen  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import record_scenario_reference as rsr  # noqa: E402

GOLDEN_BACKED = ("migration_relief", "region_loss", "region_recovery", "unreliable_supply")


def _both(name, epochs=None, **kw):
    want = rsr.run_case(jx, name, epochs=epochs, **kw)
    got = rsr.run_case(pt, name, epochs=epochs, device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("name", rsr.LIBRARY)
def test_library_scenario_matches_reference(name):
    """Every library scenario at seed 3 for 4 epochs: the reference's
    trajectory, and, as the reference's own test asks, converged, SYSTEM
    feasible and moving agents."""
    want, got = _both(name, epochs=4)
    assert rsr.mismatches(want, got) == []
    assert len(got["epochs"]) == 4 and len(got["util_spread"]) == 5
    assert all(e["converged"] and e["system_ok"] for e in got["epochs"])
    assert sum(e["migrations"] for e in got["epochs"]) > 0


@pytest.mark.parametrize("name", GOLDEN_BACKED)
def test_golden_backed_scenario_matches_live_reference(name):
    """The scenarios ``tests/golden/`` pins, at their own epoch counts."""
    want, got = _both(name)
    assert len(want["epochs"]) == tscen.SCENARIOS[name](device="cpu")[1].epochs
    assert rsr.mismatches(want, got) == []


def test_every_reference_name_is_ported():
    names = {n for n in vars(jscen) if not n.startswith("__")}
    assert names <= set(vars(tscen))
    assert sorted(tscen.SCENARIOS) == sorted(jscen.SCENARIOS)
    assert {n for n in jx.__all__ if n in vars(jscen)} <= set(pt.__all__)


def _warnings(mod, core, **kw):
    eco, sc = mod.SCENARIOS["congestion_relief"](seed=3, epochs=4, **kw)
    eco.clock = core.ClockConfig(max_rounds=50)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = mod.run_scenario(eco, sc)
    return [(w.category.__name__, str(w.message)) for w in caught
            if issubclass(w.category, RuntimeWarning)], res


def test_round_starved_warning_at_the_reference_epochs():
    """max_rounds=50 starves some epochs of congestion_relief: the port warns
    at the reference's epochs, with the reference's message."""
    want, res_j = _warnings(jscen, jx)
    got, res_t = _warnings(tscen, pt, device="cpu")
    assert got == want and len(got) >= 2
    assert all(c == "RoundStarvedWarning" and "max_rounds=50" in m for c, m in got)
    assert [s.rounds for s in res_t.stats] == [s.rounds for s in res_j.stats]
    assert not res_t.converged and res_t.total_rounds == res_j.total_rounds


def test_converged_scenario_does_not_warn():
    eco, sc = tscen.SCENARIOS["congestion_relief"](seed=3, epochs=2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", tscen.RoundStarvedWarning)
        res = tscen.run_scenario(eco, sc)
    assert res.converged and res.feasible
    assert res.total_rounds == sum(s.rounds for s in res.stats) > 0


def test_run_scenario_conservation_check_catches_drift():
    """The engine's placed-agent conservation check actually fires."""

    class BadEvent:
        epoch = 0

        def apply(self, eco):
            eco.pop.placed[:] = -1  # silently unplace everyone
            return tscen.EventReport(0, "lies about doing nothing")

    eco = pt.make_fleet_economy(seed=5, device="cpu")
    with pytest.raises(RuntimeError, match="conservation"):
        tscen.run_scenario(eco, tscen.Scenario("bad", epochs=1, events=(BadEvent(),)))


def test_scenario_result_properties_and_spread():
    """``ScenarioResult``'s properties, and the Fig. 6 headline: repeated
    auctions even out cluster utilization, as in the reference."""
    eco_j, sc_j = jscen.SCENARIOS["congestion_relief"](seed=3, epochs=6)
    eco_t, sc_t = tscen.SCENARIOS["congestion_relief"](seed=3, epochs=6, device="cpu")
    rj, rt = jscen.run_scenario(eco_j, sc_j), tscen.run_scenario(eco_t, sc_t)
    for prop in ("converged", "total_rounds", "feasible", "total_migrations", "spread_shrank"):
        assert getattr(rt, prop) == getattr(rj, prop), prop
    assert rt.util_spread == rj.util_spread and rt.spread_shrank
    assert rt.util_spread[-1] < np.median(rt.util_spread)
    assert sc_t.events_at(0) == [] and rt.scenario is sc_t


@pytest.fixture
def x64_shim(monkeypatch):
    """The reference's fused epoch calls ``jax.experimental.enable_x64``,
    which JAX 0.9.0 removed; bind it to ``jax.enable_x64`` for the test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def test_flash_crowd_fused_matches_reference_fused(x64_shim, monkeypatch):
    """flash_crowd with fused=True.  Its FlashCrowd event at epoch 2 writes
    ``pop.value`` in place and marks no device state stale, so a fused run
    settles epoch 2 on the device copy of the values from before the surge.

    On the CPU, ``jnp.asarray`` of a 64-byte aligned numpy array aliases it
    instead of copying, so the reference's fused run sees the surge or not
    with the heap alignment of ``pop.value``.  The reference's device
    constants are copies on a device (the port's always are): the test gives
    the reference copies, so its run is the one it makes on a device, and
    the port does what it does.  Marking the state stale after each event
    gives the staged path's rounds back (ROADMAP queue 3)."""
    from repro.core.economy import Economy as JEconomy

    pad_agents = JEconomy._pad_agents
    monkeypatch.setattr(JEconomy, "_pad_agents",
                        lambda self, a, fill: np.array(pad_agents(self, a, fill)))
    want, got = _both("flash_crowd", fused=True)
    assert rsr.mismatches(want, got) == []

    @dataclasses.dataclass(frozen=True)
    class Invalidating:
        epoch: int
        event: object

        def apply(self, eco):
            rep = self.event.apply(eco)
            eco.invalidate_device_state()
            return rep

    def rounds(fused, invalidate=False):
        eco, sc = tscen.flash_crowd(seed=3, device="cpu", fused=fused)
        if invalidate:
            sc = dataclasses.replace(sc, events=tuple(Invalidating(ev.epoch, ev)
                                                      for ev in sc.events))
        return [s.rounds for s in tscen.run_scenario(eco, sc).stats]

    fused = [e["rounds"] for e in got["epochs"]]
    staged = rounds(fused=False)
    assert fused[:2] == staged[:2] and fused[2] != staged[2]
    assert rounds(fused=True, invalidate=True) == staged
