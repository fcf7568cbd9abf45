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
