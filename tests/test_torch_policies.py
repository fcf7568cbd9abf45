"""The port's bidder policies against the JAX package's, action for action.

``PriceChasingPolicy`` keeps its work arrays from one ``act`` to the next;
one policy object, called on populations and subsets that grow, shrink and
change shape, has to return what a JAX-side policy returns, bit for bit,
and an action it returned earlier has to stay as it was.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.policies as jx  # noqa: E402
from repro.core.economy import AgentPopulation as JPopulation  # noqa: E402
from repro_torch.core import policies as pt  # noqa: E402
from repro_torch.core.economy import AgentPopulation  # noqa: E402

FIELDS = ("reach_bias", "redraw_reach", "pi_scale", "arbitrage", "margin")


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _case(rng, n, C, T):
    cols = dict(
        req=rng.random((n, T)) * rng.integers(1, 5), value=rng.random(n) * 10,
        home=rng.integers(-1, C, n), mobility=rng.random(n),
        relocation_cost=rng.random(n) * rng.choice([0.0, 0.1, 1.0, 5.0]),
        margin0=rng.random(n), margin_decay=rng.random(n), arbitrage=rng.random(n) * 0.3,
        budget=rng.random(n) * 10, placed=rng.integers(-1, C * T, n),
        epoch=rng.integers(0, 2000, n), fill_rate=rng.random(n),
        policy=np.zeros(n, np.int64),
    )
    belief = rng.random(C * T) * 2
    prices = belief * rng.choice([0.5, 1.0, 1.5], C * T)
    obs = dict(epoch=5, prices=prices, reserve=belief, psi=rng.random(C * T), belief=belief,
               fill_rate=cols["fill_rate"], num_clusters=C, num_rtypes=T)
    return ((AgentPopulation(names=None, **cols), pt.Observation(**obs)),
            (JPopulation(names=None, **{k: v.copy() for k, v in cols.items()}),
             jx.Observation(**obs)))


@pytest.mark.parametrize("sticky", [True, False])
def test_price_chasing_reused_matches_jax(sticky):
    rng = np.random.default_rng(30 + sticky)
    kw = dict(strength=2.0, friction=1.0, sell_prob=0.1, sticky_reach=sticky)
    port, kept = pt.PriceChasingPolicy(**kw), []
    redraws = 0
    # sizes that grow past the buffers, shrink into them, and change C and T
    for n, C, T in [(50, 4, 2), (400, 4, 2), (30, 4, 2), (400, 8, 3), (900, 8, 3), (1, 8, 3),
                    (600, 3, 1)]:
        (pop, obs), (jpop, jobs) = _case(rng, n, C, T)
        idx = np.sort(rng.choice(n, max(1, n * 3 // 4), replace=False))
        got = port.act(obs, pop, idx)
        want = jx.PriceChasingPolicy(**kw).act(jobs, jpop, idx)
        for f in FIELDS:
            assert _same(getattr(got, f), getattr(want, f)), (n, C, T, f)
        redraws += int(np.count_nonzero(got.redraw_reach))
        kept.append((got, want))
    assert redraws > 0
    for got, want in kept:  # later calls left earlier actions as they were
        for f in FIELDS:
            assert _same(getattr(got, f), getattr(want, f)), f


def _act_both(kw, pair, idx):
    (pop, obs), (jpop, jobs) = pair
    with np.errstate(all="ignore"):
        return (pt.PriceChasingPolicy(**kw).act(obs, pop, idx),
                jx.PriceChasingPolicy(**kw).act(jobs, jpop, idx))


def _assert_same_action(got, want, where=""):
    for f in FIELDS:
        assert _same(getattr(got, f), getattr(want, f)), (where, f)


def _with(pair, **cols):
    """The same case with population columns (both sides) replaced."""
    (pop, obs), (jpop, jobs) = pair
    for k, v in cols.items():
        setattr(pop, k, np.asarray(v).copy())
        setattr(jpop, k, np.asarray(v).copy())
    return (pop, obs), (jpop, jobs)


def _with_obs(pair, **fields):
    (pop, obs), (jpop, jobs) = pair
    return ((pop, pt.Observation(**{**vars(obs), **fields})),
            (jpop, jx.Observation(**{**vars(jobs), **fields})))


def test_price_chasing_fleet_subset_matches_jax():
    """A fleet-sized subset, many blocks of rows; homeless agents only in
    the last rows, so most blocks take the homed-only gate."""
    rng = np.random.default_rng(34)
    n, C, T = 100_000, 8, 3
    pair = _case(rng, n, C, T)
    home = rng.integers(0, C, n)
    home[-3_000:] = rng.integers(-1, C, 3_000)
    pair = _with(pair, home=home)
    idx = np.sort(rng.choice(n, 81_224, replace=False))
    got, want = _act_both(dict(sell_prob=0.1), pair, idx)
    _assert_same_action(got, want)
    assert 0 < np.count_nonzero(got.redraw_reach) < idx.size
    assert np.count_nonzero(got.reach_bias) > 0


def _tie_case(rng, n, C, T):
    """Integer prices, beliefs and demands, so every cost is exact, and
    relocation costs set so that the best move gain (homed) or the best
    cheapness less relocation (homeless) is exactly 0.0 for a third of the
    agents, and just above or below it for the rest."""
    pair = _case(rng, n, C, T)
    req = rng.integers(0, 4, (n, T)).astype(np.float64)
    belief = rng.integers(0, 6, C * T).astype(np.float64)
    prices = rng.integers(0, 6, C * T).astype(np.float64)
    home = rng.integers(-1, C, n)
    prev = req @ prices.reshape(C, T).T
    cheap = req @ belief.reshape(C, T).T - prev
    hc = np.clip(home, 0, C - 1)
    others = np.where(np.arange(C) == hc[:, None], np.inf, prev)
    gap = np.where(home >= 0, prev[np.arange(n), hc] - others.min(axis=1), cheap.max(axis=1))
    gap = np.where(np.isfinite(gap), gap, 0.0)
    reloc = gap + rng.choice([0.0, -0.5, 0.5], n)
    pair = _with(pair, req=req, home=home, relocation_cost=reloc)
    return _with_obs(pair, prices=prices, belief=belief, reserve=belief)


@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_price_chasing_ties_match_jax(C):
    rng = np.random.default_rng(340 + C)
    pair = _tie_case(rng, 3_000, C, 3)
    got, want = _act_both({}, pair, np.arange(3_000))
    _assert_same_action(got, want, C)


@pytest.mark.parametrize("C", [1, 3, 8])
def test_price_chasing_nan_and_inf_prices_match_jax(C):
    """NaN, +inf and -inf among the last prices and the belief: every
    action's bytes, NaN payloads and signed zeros included."""
    rng = np.random.default_rng(3400 + C)
    n, T = 2_000, 3
    pair = _case(rng, n, C, T)
    (_, obs), _ = pair
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0])
    prices, belief = obs.prices.copy(), obs.belief.copy()
    for a in (prices, belief):
        hit = rng.random(C * T) < 0.3
        a[hit] = rng.choice(specials, int(hit.sum()))
    pair = _with_obs(pair, prices=prices, belief=belief)
    got, want = _act_both(dict(sell_prob=0.2), pair, np.sort(rng.choice(n, n // 2, replace=False)))
    _assert_same_action(got, want, C)


@pytest.mark.parametrize("C,T", [(1, 3), (1, 1), (8, 3)])
def test_price_chasing_homeless_agents_match_jax(C, T):
    rng = np.random.default_rng(34_000 + C)
    n = 1_500
    pair = _with(_case(rng, n, C, T), home=np.where(rng.random(n) < 0.5, -1, rng.integers(0, C, n)))
    (_, obs), _ = pair
    pair = _with_obs(pair, prices=obs.belief * 0.5)  # every pool below belief
    got, want = _act_both({}, pair, np.arange(n))
    _assert_same_action(got, want, (C, T))
    assert np.count_nonzero(got.redraw_reach) > 0


@pytest.mark.parametrize("C", [1, 8])
def test_price_chasing_empty_subset_matches_jax(C):
    rng = np.random.default_rng(7 + C)
    got, want = _act_both({}, _case(rng, 50, C, 3), np.zeros(0, np.int64))
    _assert_same_action(got, want, C)
    assert got.reach_bias.shape == (0, C)


def test_price_chasing_acts_afresh_on_each_observation():
    """One policy object on two observations in turn, twice: each action is
    the JAX policy's for that observation, so nothing of an earlier call's
    action is reused."""
    rng = np.random.default_rng(3434)
    n, C, T = 5_000, 8, 3
    a = _case(rng, n, C, T)
    (_, obs), _ = a
    b = _with_obs(a, prices=obs.belief * rng.choice([0.5, 1.5], C * T))
    port = pt.PriceChasingPolicy(sell_prob=0.1)
    idx = np.arange(n)
    results = []
    for pair in (a, b, a, b):
        (pop, obs_p), (jpop, jobs) = pair
        got = port.act(obs_p, pop, idx)
        want = jx.PriceChasingPolicy(sell_prob=0.1).act(jobs, jpop, idx)
        _assert_same_action(got, want)
        results.append(got)
    assert not _same(results[0].reach_bias, results[1].reach_bias)
    for f in FIELDS:
        first, again = getattr(results[0], f), getattr(results[2], f)
        assert _same(first, again)
        assert first is None or not np.shares_memory(first, again)


@pytest.mark.parametrize("C", range(1, 10))
@pytest.mark.parametrize("n", [0, 1, 7, 4_099])
def test_row_folds_match_numpy_reductions(n, C):
    """``reduce_rows`` and ``rows_any`` against numpy's row-wise reductions,
    at every row width up to 9 (the word that ``rows_any`` reads a row in
    is 8, 4, 2 or 1 bytes), with NaN and signed zeros among the values."""
    rng = np.random.default_rng(n * 10 + C)
    a = rng.choice([np.nan, -0.0, 0.0, 1.0, -2.0, np.inf], (n, C)) * rng.random((n, C))
    for ufunc in (np.fmin, np.fmax):
        got, want = pt.reduce_rows(ufunc, a), ufunc.reduce(a, axis=1)
        assert got.shape == (n,) and np.array_equal(got, want, equal_nan=True)
    mask = rng.random((n, C)) < 0.1
    assert np.array_equal(pt.rows_any(mask), mask.any(axis=1))
    assert np.array_equal(pt.rows_any(np.isnan(a)), np.isnan(a).any(axis=1))
