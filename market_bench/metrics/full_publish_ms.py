"""Milliseconds of a full-record tick's commit in the record's publish: the
rename into place, the prune and the WAL's truncation (the tick's own
``commit_publish_ms``)."""
from market_bench.metrics_common import tick_mean


def read(t):
    return tick_mean(t, "commit_publish_ms", record="full")
