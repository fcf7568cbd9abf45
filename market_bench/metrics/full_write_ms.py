"""Milliseconds of a full-record tick's commit in the record's write: its
host copies, ``np.savez`` and the manifest (the tick's own
``commit_write_ms``)."""
from market_bench.metrics_common import tick_mean


def read(t):
    return tick_mean(t, "commit_write_ms", record="full")
