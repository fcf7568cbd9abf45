"""Milliseconds of a full-record tick's commit in the record's snapshot:
the book's export, the stats tree and the scalars (the tick's own
``commit_snapshot_ms``)."""
from market_bench.metrics_common import tick_mean


def read(t):
    return tick_mean(t, "commit_snapshot_ms", record="full")
