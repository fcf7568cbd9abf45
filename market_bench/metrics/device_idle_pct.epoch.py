"""Share of the profiled stretch of epochs in which no operation ran on the
device: 1 less the union of the device's kernels, copies and sets."""
from market_bench.metrics_common import idle_pct


def read(t):
    return idle_pct(t)
