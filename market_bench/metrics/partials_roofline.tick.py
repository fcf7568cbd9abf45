"""Share of its bound that the partials kernel (sparse_bid_eval_partials:
``partials_kernel`` and ``fold_levels_kernel``) reaches in the profiled
ticks: each launch's bytes at its tick's 131,072-slot book over 3.35 TB/s
(valid bundles only), summed, over the kernels' device time in the trace."""
from market_bench.metrics_common import partials_roofline


def read(t):
    return partials_roofline(t)
