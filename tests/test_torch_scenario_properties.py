"""Hypothesis twins of ``tests/test_scenario_properties.py``: the port against
the live JAX reference, on the CPU.

Each drawn event stream is applied to a port economy and to a reference
economy built alike; after every event the reports, the population arrays,
usage, capacity, base costs and the weighting must be identical, and the
port must keep the physical invariants the reference's tests ask for.
Examples are derandomized and no example database is kept, so every run
draws the same examples.  Also here: the reference's chaos counterexample
(ROADMAP queue 3), whose trajectory the port must repeat, flaw included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as jx  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro_torch import core as pt  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from test_torch_economy import _assert_state_agrees, _assert_stats_agree  # noqa: E402

N_CLUSTERS = 4
SETTINGS = dict(deadline=None, derandomize=True, database=None)

# (event class name, its keyword arguments): built in each package
_events = st.one_of(
    st.fixed_dictionaries({
        "cluster": st.integers(0, N_CLUSTERS - 1), "scale": st.floats(0.0, 2.0, allow_nan=False),
        "rtype": st.sampled_from([None, 0, 1, 2])}).map(lambda kw: ("CapacityShock", kw)),
    st.fixed_dictionaries({
        "value_scale": st.floats(0.1, 5.0, allow_nan=False),
        "fraction": st.floats(0.0, 1.0, allow_nan=False), "cluster": st.sampled_from([None, 0, 1]),
        "seed": st.integers(0, 2**16)}).map(lambda kw: ("FlashCrowd", kw)),
    st.fixed_dictionaries({
        "num_agents": st.integers(1, 8), "seed": st.integers(0, 2**16),
        "value_mult": st.floats(0.5, 3.0, allow_nan=False)}).map(lambda kw: ("Arrivals", kw)),
    st.fixed_dictionaries({
        "fraction": st.floats(0.0, 1.0, allow_nan=False), "cluster": st.sampled_from([None, 0, 2]),
        "seed": st.integers(0, 2**16)}).map(lambda kw: ("Departures", kw)),
    st.fixed_dictionaries({
        "rtype": st.integers(0, 2),
        "scale": st.floats(0.25, 4.0, allow_nan=False)}).map(lambda kw: ("BaseCostChange", kw)),
    st.fixed_dictionaries({
        "weighting": st.sampled_from(["exp", "logistic", "piecewise"])}).map(
        lambda kw: ("WeightingSwap", kw)),
)


def _same_economy(ej, et):
    for f in ("req", "value", "home", "relocation_cost", "mobility", "placed", "epoch",
              "fill_rate", "policy"):
        a, b = getattr(ej.pop, f), getattr(et.pop, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("usage", "capacity", "base_cost_rt", "belief"):
        assert np.array_equal(getattr(ej, f), getattr(et, f)), f
    assert type(ej.weighting).__name__ == type(et.weighting).__name__
    assert dataclasses.asdict(ej.weighting) == dataclasses.asdict(et.weighting)


@settings(max_examples=40, **SETTINGS)
@given(events=st.lists(_events, max_size=6), seed=st.integers(0, 7))
def test_any_event_stream_matches_reference_and_stays_physical(events, seed):
    """Usage ∈ [0, capacity], capacity ≥ 0, population non-empty, placed
    agents conserved — and every event's report and effect the reference's."""
    ej = jx.make_fleet_economy(num_clusters=N_CLUSTERS, num_agents=12, seed=seed)
    et = pt.make_fleet_economy(num_clusters=N_CLUSTERS, num_agents=12, seed=seed, device="cpu")
    for kind, kw in events:
        placed_before = int((et.pop.placed >= 0).sum())
        rj = getattr(jx, kind)(epoch=0, **kw).apply(ej)
        rt = getattr(pt, kind)(epoch=0, **kw).apply(et)
        assert dataclasses.asdict(rj) == dataclasses.asdict(rt), kind
        _same_economy(ej, et)
        placed = int((et.pop.placed >= 0).sum())
        assert placed == placed_before + rt.placed_added - rt.placed_removed
        assert (et.usage >= -1e-9).all() and (et.usage <= et.capacity + 1e-9).all()
        assert (et.capacity >= 0).all() and len(et.pop) >= 1
        assert len(et.pop) == et.pop.placed.shape[0] == et.pop.req.shape[0]
        assert (et.pop.placed < et.C).all() and (et.pop.home < et.C).all()


@settings(max_examples=25, **SETTINGS)
@given(frac=st.floats(0.0, 1.0, allow_nan=False), seed=st.integers(0, 2**16))
def test_departures_free_exactly_what_the_reference_frees(frac, seed):
    ej = jx.make_fleet_economy(num_clusters=N_CLUSTERS, num_agents=12, seed=3)
    et = pt.make_fleet_economy(num_clusters=N_CLUSTERS, num_agents=12, seed=3, device="cpu")
    leave = np.random.default_rng(seed).random(12) < frac
    held = leave & (et.pop.placed >= 0)
    expected = et.usage.copy()
    np.add.at(expected, et.pop.placed[held], -et.pop.req[held])
    assert et.remove_agents(leave) == ej.remove_agents(leave) == int(held.sum())
    np.testing.assert_array_equal(et.usage, np.maximum(expected, 0.0))
    _same_economy(ej, et)


@settings(max_examples=25, **SETTINGS)
@given(seed=st.integers(0, 2**16), num=st.integers(1, 10))
def test_arrivals_conserve_existing_state_as_the_reference(seed, num):
    ej = jx.make_fleet_economy(num_clusters=N_CLUSTERS, num_agents=12, seed=5)
    et = pt.make_fleet_economy(num_clusters=N_CLUSTERS, num_agents=12, seed=5, device="cpu")
    placed0, value0 = et.pop.placed.copy(), et.pop.value.copy()
    assert et.add_agents(pt.fleet_population(num, N_CLUSTERS, seed=seed)) == ej.add_agents(
        jx.fleet_population(num, N_CLUSTERS, seed=seed))
    assert len(et.pop) == 12 + num
    np.testing.assert_array_equal(et.pop.placed[:12], placed0)
    np.testing.assert_array_equal(et.pop.value[:12], value0)
    assert (et.usage <= et.capacity + 1e-9).all()
    _same_economy(ej, et)


def _chaos(fm, seed, **kw):
    faults = fm.FaultModel(seed=0, pool_fail=0.4, region_faults=(
        fm.RegionFault(0, 0, None, 0.0), fm.RegionFault(0, 0, None, 0.0),
        fm.RegionFault(1, 2, None, 0.0)))
    return dict(num_clusters=4, num_agents=24, seed=seed, faults=faults, clock_retries=1,
                ration_fallback=True, **kw)


# the agents left placed in a dead region after epoch 2, by seed (both packages)
STRANDED = {0: [], 1: [2, 4], 2: [3, 8, 14], 3: [0, 1, 5, 7, 8]}


@pytest.mark.parametrize("seed", sorted(STRANDED))
def test_chaos_counterexample_repeats_the_reference(seed):
    """``test_fault_properties.py``'s counterexample: cluster 0 dead from
    epoch 0, faulted twice, cluster 1 dead from epoch 2, pools failing at
    0.4.  The reference leaves agents placed in a dead region at epoch 2 for
    seeds 1-3; the port settles every epoch as the reference does and
    strands the same agents (pinned, not repaired)."""
    ej = jx.make_fleet_economy(**_chaos(jfaults, seed))
    et = pt.make_fleet_economy(**_chaos(tfaults, seed, device="cpu"))
    for epoch in range(3):
        sj, st_ = ej.run_epoch(), et.run_epoch()
        _assert_stats_agree(sj, st_, (seed, epoch))
        _assert_state_agrees(ej, et)
        np.testing.assert_array_equal(ej.pool_reliability, et.pool_reliability)
        np.testing.assert_array_equal(ej._last_cap_eff, et._last_cap_eff)
    stranded = []
    for eco in (ej, et):
        dead = np.flatnonzero((eco._last_cap_eff <= 1e-12).all(axis=1))
        assert dead.tolist() == [0, 1]
        stranded.append(np.flatnonzero(np.isin(eco.pop.placed, dead)).tolist())
    assert stranded == [STRANDED[seed]] * 2
