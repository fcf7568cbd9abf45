"""Milliseconds a tick in settlement: the clock and its escalations on the
mirror (the tick's own ``settle_ms``)."""
from market_bench.metrics_common import tick_mean


def read(t):
    return tick_mean(t, "settle_ms")
