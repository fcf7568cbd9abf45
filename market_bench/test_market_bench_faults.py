"""The output check catches the program broken underneath a run: a step that
leaves its state unchanged, half of the bids left out, an answer altered
where it is produced.  (A cell on one chip has no exchange between chips
to leave out.)"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from market_bench import testing

FLEET = ["fleet-8c-100k.steady", "fleet-8c-100k.outage"]
SERVICE = "service-8c-131k.churn"


def _fused():
    from repro_torch.core.fused import FusedEpoch

    return FusedEpoch


def state_unchanged(monkeypatch):
    FusedEpoch = _fused()
    orig = FusedEpoch.__call__

    def call(self, const, state, inputs):
        held = state.as_tuple() if hasattr(state, "as_tuple") else tuple(state)
        before = [t.clone() for t in held]
        out = orig(self, const, state, inputs)
        for t, b in zip(held, before):
            t.copy_(b)
        for k, b in zip(("placed_new", "home_new", "fill_new", "usage_new", "belief_new"),
                        before):
            out[k] = b
        return out

    monkeypatch.setattr(FusedEpoch, "__call__", call)


def half_left_out(monkeypatch):
    from repro_torch.core import Economy

    orig = Economy._fused_prepare

    def prepare(self, dry_run):
        prep = orig(self, dry_run)
        drop = np.arange(prep["dropout"].shape[0]) % 2 == 0
        prep["dropout"] = prep["dropout"] | drop
        return prep

    monkeypatch.setattr(Economy, "_fused_prepare", prepare)


def answer_altered(monkeypatch):
    FusedEpoch = _fused()
    orig = FusedEpoch.__call__

    def call(self, const, state, inputs):
        out = orig(self, const, state, inputs)
        out["prices"] = out["prices"] * 1.001
        return out

    monkeypatch.setattr(FusedEpoch, "__call__", call)


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", FLEET)
def test_fleet_fault_is_caught(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = testing.run(workload, seconds=0.05)
    assert not out["correct"], out["checks"]


def tick_unchanged(monkeypatch):
    from repro_torch.serve.market import MarketService

    def drain(self):
        self._pending.clear()
        return 0, 0

    monkeypatch.setattr(MarketService, "_drain", drain)


def half_not_queued(monkeypatch):
    from repro_torch.serve.market import MarketService

    orig = MarketService.submit
    calls = []

    def submit(self, delta):
        calls.append(1)
        return True if len(calls) % 2 else orig(self, delta)

    monkeypatch.setattr(MarketService, "submit", submit)


def prices_altered(monkeypatch):
    from repro_torch.serve.market import MarketService

    orig = MarketService._settle

    def settle(self, problem, start, deadline_s):
        result, esc, missed = orig(self, problem, start, deadline_s)
        return dataclasses.replace(result, prices=result.prices * 1.001), esc, missed

    monkeypatch.setattr(MarketService, "_settle", settle)


@pytest.mark.parametrize("fault", [tick_unchanged, half_not_queued, prices_altered],
                         ids=lambda f: f.__name__)
def test_service_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    out = testing.run(SERVICE, seconds=0.05)
    assert not out["correct"], out["checks"]
