"""``AgentPopulation.margins()`` against the plain ``margin0 · decay^epoch``.

``margins()`` skips the powers that must underflow to +0.0 and takes that
zero instead; the results are compared as raw bits, so signed zeros, the
subnormal band just before the underflow and NaN payloads all count.
"""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core.economy import AgentPopulation  # noqa: E402

DECAYS = (0.0, -0.0, 5e-324, 1e-300, 0.3, 0.5, 0.999999, 1.0, 1.5, -0.3, np.inf, np.nan)
# 560..700 spans the subnormal band of decay 0.3 (589..619) and the first
# skipped epochs past it
EPOCHS = (-5, 0, 1, *range(560, 701), 1_000, 10**6, 2**62)
MARGIN0 = (1.25, -1.5, 0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan)


def _population(margin0, decay, epoch) -> AgentPopulation:
    n = len(margin0)
    return AgentPopulation(
        req=np.ones((n, 1)), value=1.0, home=0, relocation_cost=0.0,
        mobility=1.0, margin0=np.asarray(margin0, np.float64),
        margin_decay=np.asarray(decay, np.float64), arbitrage=0.0, budget=np.inf,
        placed=-1, epoch=np.asarray(epoch, np.int64),
    )


def _grid(decays):
    rows = list(itertools.product(MARGIN0, decays, EPOCHS))
    return tuple(np.array(c) for c in zip(*rows))


def _fleet(n, established_share, seed=0):
    rng = np.random.default_rng(seed)
    young = rng.integers(0, 6, n)
    epoch = np.where(rng.random(n) < established_share, 1_000, young)
    return rng.uniform(0.5, 2.0, n), np.full(n, 0.3), epoch


CASES = {
    **{f"decay={d!r}": _grid((d,)) for d in DECAYS},
    "whole-grid": _grid(DECAYS),
    "fleet-young": _fleet(2_000, 0.0),
    "fleet-mixed": _fleet(2_000, 0.5),
    "fleet-established": _fleet(2_000, 1.0),
    "empty": (np.zeros(0), np.zeros(0), np.zeros(0, np.int64)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_margins_bit_identical_to_plain_power(case):
    margin0, decay, epoch = CASES[case]
    pop = _population(margin0, decay, epoch)
    with np.errstate(all="ignore"):
        want = pop.margin0 * pop.margin_decay ** pop.epoch
        got = pop.margins()
    assert got.dtype == want.dtype and got.shape == want.shape
    bad = np.flatnonzero(got.view(np.uint64) != want.view(np.uint64))
    assert bad.size == 0, [
        (pop.margin0[i], pop.margin_decay[i], int(pop.epoch[i]), got[i], want[i]) for i in bad[:8]
    ]
