"""The adaptive fleet cell at a small size on the CPU: the program with the
three bidder policies against the plain reference that folds their
actions into each epoch; the check catches the policies' inputs left out
or altered, and fails its bfloat16 control; the reference's policies act
as the program's do."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from market_bench import adaptive_cell, economy_cell, fleet, harness, testing
from market_bench.reference import adaptive as ref

CELL = "fleet-8c-100k-adaptive.steady"


def _gaps_exceeded(readings, limits):
    return {k: readings[k] for k, v in limits.items() if readings[k] > v}


def test_every_gap_is_zero_over_epochs_in_which_chasers_act(tmp_path):
    sut, limits = testing.sut(CELL, 3141592653, 0.0, str(tmp_path), agents=1500, warmup=5,
                              check_sample=0)
    redraws = [c["policy_redraws"] for c in sut.policy_counts[:5]]
    assert sum(r > 0 for r in redraws) >= 4, redraws
    readings = sut.check(testing.CPU)
    assert readings["epochs_compared"] == 5
    assert all(readings[k] == 0 for k in limits), readings


def policies_skipped(monkeypatch):
    from repro_torch.core import Economy

    monkeypatch.setattr(Economy, "_apply_policies",
                        lambda self, perm_keys, dry_run: (perm_keys, None, None, None))


def sticky_keys_not_restored(monkeypatch):
    from repro_torch.core import Economy

    orig = Economy._apply_policies

    def apply(self, perm_keys, dry_run):
        self._reach_keys = None  # nothing stored: every agent takes its fresh draw
        return orig(self, perm_keys, dry_run)

    monkeypatch.setattr(Economy, "_apply_policies", apply)


def pi_scale_dropped(monkeypatch):
    from repro_torch.core import Economy

    orig = Economy._apply_policies

    def apply(self, perm_keys, dry_run):
        keys, _, arb, margin = orig(self, perm_keys, dry_run)
        return keys, None, arb, margin

    monkeypatch.setattr(Economy, "_apply_policies", apply)


@pytest.mark.parametrize("fault", [policies_skipped, sticky_keys_not_restored, pi_scale_dropped],
                         ids=lambda f: f.__name__)
def test_a_planted_fault_is_caught(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    sut, limits = testing.sut(CELL, 2718281828, 0.0, str(tmp_path), warmup=4, check_sample=0)
    assert _gaps_exceeded(sut.check(testing.CPU), limits)


def test_a_planted_fault_reads_incorrect_end_to_end(monkeypatch):
    policies_skipped(monkeypatch)
    out = testing.run(CELL, seconds=0.05)
    assert not out["correct"], out["checks"]


def test_the_bfloat16_control_fails_where_chasers_act(tmp_path):
    sut, limits = testing.sut(CELL, 2024, 0.0, str(tmp_path), agents=300, max_rounds=1000,
                              warmup=2, check_sample=0)
    assert not _gaps_exceeded(sut.check(testing.CPU), limits)
    assert _gaps_exceeded(sut.check(testing.CPU, torch.bfloat16), limits)


def test_a_program_without_policy_counts_runs_the_cell(monkeypatch):
    """As a program that keeps no ``last_policy_counts``: correct, its
    redraws unread."""
    from repro_torch.core import Economy

    orig = Economy._apply_policies

    def apply(self, perm_keys, dry_run):
        out = orig(self, perm_keys, dry_run)
        self.__dict__.pop("last_policy_counts", None)
        return out

    monkeypatch.setattr(Economy, "_apply_policies", apply)
    out = testing.run(CELL, seconds=0.5, traced=True)
    assert out["correct"], out["checks"]
    assert out["readings"]["policy_redraws"] is None
    assert "policy_redraws" not in out["metrics"] and "policies_ms" in out["metrics"]


def test_a_traced_run_reads_the_policy_metrics():
    out = testing.run(CELL, seconds=1.0, traced=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["policies_ms"]["value"] > 0.0 and m["policy_redraws"]["value"] > 0.0
    assert {"economy_host_ms", "margins_ms", "clock_rounds"} <= set(m)


def _population(seed: int, n: int = 2000, C: int = 4):
    """A seeded fleet and a state in the middle of a run: homes, holdings,
    fills, beliefs and last prices drawn at random."""
    _, _, cfg, _ = harness.cell_spec(CELL)
    cfg = dict(cfg, agents=n, clusters=C)
    pop = fleet.population(cfg, seed)
    pop["policy"] = adaptive_cell.policy_ids(cfg, pop)
    rng = np.random.default_rng(seed)
    T = pop["req"].shape[1]
    base = np.tile(np.asarray(cfg["base_cost"]), C)
    st = ref.initial_state(cfg, pop, np.zeros((C, T)), seed)
    st.home = np.where(rng.random(n) < 0.1, -1, rng.integers(0, C, n))
    st.placed = np.where(rng.random(n) < 0.5, st.home, -1)
    st.fill_rate = rng.random(n)
    st.belief = base * rng.uniform(0.5, 3.0, C * T)
    st.prices = (base * rng.uniform(0.3, 4.0, C * T)).astype(np.float32)
    st.reserve = st.prices.copy()
    st.bids = 3
    st.reach_keys = rng.random((n, C))
    st.reach_keys[rng.random(n) < 0.05] = np.nan  # agents with nothing stored
    return cfg, pop, st


def _program(cfg, pop, st):
    from repro_torch.core import AgentPopulation, Observation
    from repro_torch.core.policies import POLICY_REGISTRY

    n = pop["req"].shape[0]
    agents = AgentPopulation(epoch=np.full(n, st.bids, np.int64), **dict(
        pop, home=st.home, placed=st.placed, fill_rate=st.fill_rate))
    C, T = int(cfg["clusters"]), pop["req"].shape[1]
    obs = Observation(epoch=5, prices=st.prices, reserve=st.reserve, psi=np.zeros(C * T),
                      belief=st.belief, fill_rate=st.fill_rate, num_clusters=C, num_rtypes=T)
    pols = [POLICY_REGISTRY[p["name"]](**{k: v for k, v in p.items() if k != "name"})
            for p in cfg["policies"]]
    return agents, obs, pols


@pytest.mark.parametrize("seed", [1, 2 ** 33 + 5])
def test_reference_policies_act_as_the_programs(seed):
    cfg, pop, st = _population(seed)
    agents, obs, pols = _program(cfg, pop, st)
    C, T = int(cfg["clusters"]), pop["req"].shape[1]
    chasers = 0
    for (idx, want), pol in zip(ref.actions(cfg, pop, st, C, T), pols):
        got = pol.act(obs, agents, idx)
        assert (got is None) == (want is None), pol.name
        if got is None:
            continue
        own = {"arbitrage": pop["arbitrage"][idx], "margin": ref.margins(pop, st.bids)[idx]}
        for field, port in (("redraw", "redraw_reach"), ("bias", "reach_bias"),
                            ("pi_scale", "pi_scale"), ("arbitrage", "arbitrage"),
                            ("margin", "margin")):
            a, b = getattr(want, field), getattr(got, port)
            if b is None and a is not None and field in own:
                b = own[field]  # the program leaves an unchanged override out
            assert (a is None) == (b is None), field
            if a is not None:
                np.testing.assert_array_equal(np.broadcast_to(b, np.shape(a)), a, err_msg=field)
        if want.redraw is not None:
            chasers += int(want.redraw.sum())
    assert 0 < chasers < (pop["policy"] == 1).sum()  # some chase, some stay


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 7])
def test_reference_fold_is_the_programs(seed):
    """The epoch's reach keys, π scales, sell intents and margins after the
    fold, and the keys stored for the next epoch, as the program's
    ``Economy._apply_policies`` gives them on the same state."""
    cfg, pop, st = _population(seed)
    cap = fleet.capacity(dict(cfg))
    eco = economy_cell.economy(cfg, pop, cap, np.zeros_like(cap), seed, testing.CPU,
                                policies=_program(cfg, pop, st)[2], fused=True)
    eco.pop.home, eco.pop.placed, eco.pop.fill_rate = st.home, st.placed, st.fill_rate
    eco.pop.epoch[:] = st.bids
    eco.belief, eco.price_history, eco._reach_keys = st.belief, [st.prices], st.reach_keys.copy()
    C, T = int(cfg["clusters"]), pop["req"].shape[1]
    draw = np.random.default_rng(seed).random((pop["req"].shape[0], C))
    keys, stored, pi_scale, arb, margin = ref.fold(cfg, pop, st, draw.copy(), C, T)
    got = eco._apply_policies(draw.copy(), dry_run=False)
    own = (None, np.ones_like(pi_scale), pop["arbitrage"], ref.margins(pop, st.bids))
    for a, b, default in zip((keys, pi_scale, arb, margin), got, own):
        np.testing.assert_array_equal(default if b is None else b, a)
    np.testing.assert_array_equal(eco._reach_keys, stored)
