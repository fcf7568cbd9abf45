"""Milliseconds of a tick's commit where it cut a full record (the tick's
own ``commit_ms`` and ``record``)."""
from market_bench.metrics_common import tick_mean


def read(t):
    return tick_mean(t, "commit_ms", record="full")
