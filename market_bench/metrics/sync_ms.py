"""Milliseconds a tick writing the rows changed since the last tick into the
book's device mirror (the tick's own ``sync_ms``)."""
from market_bench.metrics_common import tick_mean


def read(t):
    return tick_mean(t, "sync_ms")
