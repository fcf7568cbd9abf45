"""Milliseconds a tick in the service's drain of its queued deltas into the
book (the tick's own ``drain_ms``)."""
from market_bench.metrics_common import tick_mean


def read(t):
    return tick_mean(t, "drain_ms")
