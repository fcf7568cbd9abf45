"""Arithmetic shared by the per-layer metrics' readers (``metrics/``)."""
from __future__ import annotations

from . import peaks

PARTIALS_KERNELS = ("partials_kernel", "fold_levels_kernel")


def partials_roofline(t):
    """Sum over the profiled launches of the partials kernel of its bound at
    its book, over the kernel's device time in the trace, in percent."""
    calls = t.counters.get("partials_calls")
    device_s = sum(d for name, _, d in t.kernels if any(k in name for k in PARTIALS_KERNELS))
    if not calls or device_s <= 0 or any(shape is None for _, shape in calls):
        return None
    bound = 0.0
    for launches, (rows, bundles, terms, valid, pools, blocks) in calls:
        bound += launches * peaks.live_book_bound_s(rows, bundles, terms, valid, pools,
                                                    4 * blocks * pools)
    return 100.0 * bound / device_s if bound > 0 else None


def idle_pct(t):
    if not t.window_s or t.busy_s is None or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def tick_mean(t, key: str, record: str | None = None):
    rows = [d for d in getattr(t, "timings", []) if key in d
            and (record is None or d.get("record") == record)]
    return sum(d[key] for d in rows) / len(rows) if rows else None
