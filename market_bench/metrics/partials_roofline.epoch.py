"""Share of its bound that the partials kernel (sparse_bid_eval_partials:
``partials_kernel`` and ``fold_levels_kernel``) reaches in the profiled
epochs: each launch's bytes at its epoch's blocked book over 3.35 TB/s
(valid bundles only), summed, over the kernels' device time in the trace."""
from market_bench.metrics_common import partials_roofline


def read(t):
    return partials_roofline(t)
